"""Dense GQA flash attention (bucket prefill)."""
