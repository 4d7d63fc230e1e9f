"""The roofline of a step on H100s (the counterpart of
:mod:`repro.roofline`)."""
from repro_torch.roofline.analysis import (  # noqa: F401
    HARDWARE, RooflineReport, collective_bytes_of_plan, model_flops_for,
    roofline_terms)
