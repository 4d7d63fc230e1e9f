# Hand-written CUDA kernels of the port (csrc/relax.cu, built at first use
# by _build.py) and their wrappers, each with a plain PyTorch version that
# runs for CPU tensors:
#
#   relax         - B1 wd_relax_lanes (merge-path search fused with the
#                   relax) and B2 relax_lanes (direct-mapped lanes), plus
#                   apply_proposal / apply_relax
#   find_offsets  - B3, the paper's WD offset search
from repro_torch.kernels import find_offsets, ops, ref, relax  # noqa: F401
