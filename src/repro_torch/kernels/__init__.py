# Hand-written CUDA kernels of the port (csrc/*.cu, built at first use by
# _build.py) and their wrappers, each with a plain PyTorch version that
# runs for CPU tensors:
#
#   relax           - B1 wd_relax_lanes (merge-path search fused with the
#                     relax) and B2 relax_lanes (direct-mapped lanes), plus
#                     their folds into dist: apply_relax / wd_apply_relax
#   find_offsets    - B3, the paper's WD offset search
#   flash_attention - B4, GQA flash attention (LM prefill) and its backward
#                     kernels (training)
#   ssd_chunk       - B5, Mamba-2 SSD intra-chunk dual form (LM prefill) and
#                     its backward kernel (training)
#   fused           - the fused fixed point: a whole traversal in one
#                     persistent cooperative launch (B1/B2's lane bodies)
#   cost            - B4/B5's closed-form (bytes, FLOPs) a call, and the
#                     counter their meta branches (the dry run) feed
#   opgen           - a user-defined EdgeOp lowered to C++, for the relax
#                     and fused kernels built for it at first use
from repro_torch.kernels import (  # noqa: F401
    find_offsets, flash_attention, fused, opgen, ops, ref, relax, ssd_chunk)
