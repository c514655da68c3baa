"""AdamW and learning-rate schedules of the training step."""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update, clip_by_global_norm,
                                     global_norm)
