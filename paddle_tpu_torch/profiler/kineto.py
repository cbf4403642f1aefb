"""The card's kernels from a ``torch.profiler`` recording, as chrome events.

Counterpart of ``paddle_tpu/profiler/xplane.py``, which decodes the TPU
trace's device plane (``device_trace_events``, ``xplane.py:158``) into
chrome ``"X"`` spans. Here the device timeline comes from CUPTI through
kineto, torch.profiler's tracer, and this module turns its CUDA activity
into the same dict shape ``statistic.py`` takes::

    {"name": <kernel name>, "ph": "X", "cat": "device",
     "ts": <us>, "dur": <us>, "pid": "/device:GPU:<n>",
     "tid": "Kernels" | "Memcpy" | "Memset"}

Left out: the host side (CPU ops, covered by the host tracer) and user
annotations (``record_function`` ranges, such as ``ProfileStep#n`` or a
``RecordEvent``, which kineto also lays over the device timeline as
``gpu_user_annotation`` spans: counting them would count their kernels
twice).
"""
from __future__ import annotations

from typing import Iterable, List, Optional


def _lane(name: str) -> str:
    if name.startswith("Memcpy"):
        return "Memcpy"
    if name.startswith("Memset"):
        return "Memset"
    return "Kernels"


def device_trace_events(prof, t0_us: float = 0.0,
                        skip_names: Optional[Iterable[str]] = None
                        ) -> List[dict]:
    """The CUDA kernels, copies and fills of a finished
    ``torch.profiler.profile`` recording (``prof.events()``), each as a
    chrome event of the module docstring's shape. ``t0_us`` is added to
    kineto's timestamps (microseconds from the start of the recording),
    to place them on a host timeline; a name in ``skip_names`` (host
    spans whose ranges kineto also laid on the device) is left out,
    besides every event kineto marks as a user annotation."""
    from torch.autograd import DeviceType

    skip = set(skip_names or ())
    out: List[dict] = []
    for e in prof.events() or ():
        if e.device_type != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name in skip \
                or e.name.startswith("ProfilerStep#"):
            continue
        out.append({
            "name": e.name, "ph": "X", "cat": "device",
            "ts": t0_us + e.time_range.start,
            "dur": max(e.time_range.elapsed_us(), 0.001),
            "pid": f"/device:GPU:{e.device_index}",
            "tid": _lane(e.name),
        })
    return out

