"""presto_tpu_torch — the PyTorch/CUDA port of presto_tpu.

The same SQL engine (parser, planner, optimizer, connectors) over pages
of torch tensors on a CUDA device instead of JAX arrays on a TPU. The
front end is a copy of the reference's host-only modules; the device
side (page, staging, expressions, operators, runner) is PyTorch, and
the one kernel the reference wrote by hand (the one-hot grouped
reduction) is CUDA C++ under ``csrc/``.

Entry point: ``presto_tpu_torch.exec.local_runner.LocalQueryRunner``;
it runs on the CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from presto_tpu_torch.session import Session  # noqa: E402,F401
