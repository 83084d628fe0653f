"""orange3_spark_tpu_torch — the PyTorch/CUDA port of orange3_spark_tpu.

It grows beside the JAX package, slice by slice, with the same layout
(``core/``, ``ops/``, ``models/``) and the same public names. It imports
``torch`` and numpy, never ``jax`` and nothing of ``orange3_spark_tpu``.
Kernels that the JAX package wrote in Pallas for the TPU are hand-written
CUDA here (``ops/csrc/``), built with ``nvcc`` on first use.

Entry points run on the GPU unless the caller asks for the CPU:
``TorchSession()`` selects ``cuda`` and raises without it;
``TorchSession("cpu")`` runs every op through its plain PyTorch version.
"""

from orange3_spark_tpu_torch.core.session import TorchSession
from orange3_spark_tpu_torch.core.table import TorchTable

__all__ = ["TorchSession", "TorchTable"]
