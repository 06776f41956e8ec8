"""paddlebox_tpu_torch — the PyTorch/CUDA port of paddlebox_tpu.

A second package beside the JAX reference: the same BoxPS sparse-CTR
training pass (host table → device working set → sorted-SpMM pull →
DeepFM → sorted-SpMM merged push → sparse optimizer → end_pass
write-back), with the reference's Pallas kernels rewritten by hand in
CUDA C++ for Hopper (``csrc/``).  It imports torch and never JAX, and
nothing of ``paddlebox_tpu``.

Submodules are imported explicitly (``paddlebox_tpu_torch.ps.pass_manager``
and so on); importing the package itself loads only the flag registry.
"""

from paddlebox_tpu_torch.version import __version__  # noqa: F401
from paddlebox_tpu_torch import flags  # noqa: F401

set_flags = flags.set_flags
get_flags = flags.get_flags
