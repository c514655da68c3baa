"""Dense attention-only decoder stack of the port (SmolLM, Qwen2.5,
Granite 3): parameter trees, layers, paged attention, model API."""
