"""The optimizer and learning-rate schedules of the port (the counterpart
of :mod:`repro.optim`)."""
from repro_torch.optim.adamw import AdamW, clip_by_global_norm  # noqa: F401
from repro_torch.optim.schedules import linear, warmup_cosine  # noqa: F401
