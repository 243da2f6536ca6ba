"""The public names of the hand-written kernels, so that callers read as
in the reference (``kops.sparse_gram(...)``).

There is no mode switch here: each wrapper dispatches on the device of the
tensor it is given (CUDA: the kernel, or an exception; CPU: the plain
version), and the kernels mask ragged edges themselves, so nothing is
padded or tiled on the way in.
"""
from repro_torch.kernels.blockgram import blockgram  # noqa: F401
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.right_vectors import right_vectors  # noqa: F401
from repro_torch.kernels.sketch_panel import sketch_panel  # noqa: F401
from repro_torch.kernels.sparse_gram import sparse_gram  # noqa: F401
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: F401
from repro_torch.kernels.topk_score import topk_score  # noqa: F401
