"""Step-atomic checkpoints of the port (the counterpart of
:mod:`repro.checkpoint`)."""
from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncCheckpointer, assign, latest_step, restore_checkpoint,
    save_checkpoint)
