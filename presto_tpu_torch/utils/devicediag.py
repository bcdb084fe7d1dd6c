"""Structured device-backend diagnosis.

The PyTorch twin of ``presto_tpu/utils/devicediag.py``: the device init
path runs as three separately attributed phases, and the outcome is
recorded as data (``system.runtime.nodes.backend_diag``):

- ``enumerate`` — ``torch.cuda.device_count()`` and the device's name:
  the CUDA runtime reports the card;
- ``compile`` — the port's hand-written kernel (K1,
  ``csrc/onehot_reduce.cu``) builds with ``nvcc`` and loads through
  ``presto_tpu_torch/kernels.py``: the toolchain behind the card answers;
- ``execute`` — one K1 launch on a small fixed input, held against its
  plain PyTorch version: the card really runs the port's kernel.

Unlike the reference's probe, a failed phase is recorded AND raised to
the caller: the port never falls back quietly. On the CPU (``device``
"cpu") the probe enumerates the host and runs no kernel.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Optional

from presto_tpu_torch.utils.metrics import REGISTRY


@dataclasses.dataclass
class BackendDiag:
    """One probe's structured outcome."""

    backend: str = ""  # "gpu" or "cpu" ("" = none came up)
    #: first failing phase (enumerate|compile|execute), or "ok"
    phase: str = "ok"
    ok: bool = True
    error_class: str = ""
    error: str = ""
    device_count: int = 0
    probed_at: float = 0.0
    #: the probed device's name (``torch.cuda.get_device_name``)
    device_name: str = ""
    #: phase -> "ok" | "failed" | "skipped" (the CPU runs no kernel)
    phases: Dict[str, str] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


_LOCK = threading.Lock()
_LAST: Optional[BackendDiag] = None


def record_diag(diag: BackendDiag) -> BackendDiag:
    """Install ``diag`` as the process's last probe outcome."""
    global _LAST
    REGISTRY.counter("device.probes").update()
    if not diag.ok:
        REGISTRY.counter("device.probe_failures").update()
    with _LOCK:
        _LAST = diag
    return diag


def last_diag() -> Optional[BackendDiag]:
    with _LOCK:
        return _LAST


def last_diag_dict() -> dict:
    """The last probe as a plain dict ({} = never probed)."""
    d = last_diag()
    return d.to_dict() if d is not None else {}


def _execute_k1(device) -> None:
    """One K1 launch over a small fixed input, equal to the plain
    version bit for bit (integer count and sum)."""
    import torch

    from presto_tpu_torch.ops import aggregation as PA

    n, nseg = 4096, 5
    gid = (torch.arange(n, dtype=torch.int32, device=device) * 7) % (nseg + 1)
    x = torch.arange(n, dtype=torch.int64, device=device) - n // 3
    reqs = [("count", None, None), ("sum", x, None)]
    got = PA.onehot_reduce_many(gid, reqs, nseg).cpu()
    want = PA.onehot_reduce_many_plain(gid.cpu(), [
        ("count", None, None), ("sum", x.cpu(), None)
    ], nseg)
    if not torch.equal(got, want):
        raise RuntimeError(
            f"onehot_reduce on {device} disagrees with its plain version"
        )


def probe_backend(device=None) -> BackendDiag:
    """Run the three-phase probe on ``device`` (None: the CUDA device,
    as the runner resolves it), record the outcome, and return it; a
    failed phase is recorded, then raised."""
    import torch

    diag = BackendDiag(probed_at=time.time())
    dev = torch.device("cuda" if device is None else device)
    phase = "enumerate"
    try:
        if dev.type == "cpu":
            diag.backend = "cpu"
            diag.device_count = 1
            diag.device_name = "cpu"
            diag.phases = {"enumerate": "ok", "compile": "skipped",
                           "execute": "skipped"}
            return record_diag(diag)
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        diag.device_count = torch.cuda.device_count()
        diag.device_name = torch.cuda.get_device_name(dev)
        diag.backend = "gpu"
        diag.phases["enumerate"] = "ok"

        phase = "compile"
        from presto_tpu_torch import kernels

        kernels.load("onehot_reduce")
        # the probe's build is no query's: no run takes it later
        kernels.take_builds()
        diag.phases["compile"] = "ok"

        phase = "execute"
        _execute_k1(dev)
        diag.phases["execute"] = "ok"
        diag.phase = "ok"
    except Exception as e:
        diag.ok = False
        diag.phase = phase
        diag.phases[phase] = "failed"
        diag.error_class = type(e).__name__
        diag.error = str(e)[:300]
        record_diag(diag)
        raise
    return record_diag(diag)
