"""Named spans at the frame loop's layer boundaries, for the PyTorch
profiler's trace.

``span(name)`` records ``name`` as a ``torch.profiler.record_function``
range while a profiler runs (``api.run(profile_dir=)``, ``--profile DIR``,
``KANI_PROFILE``, or any ``torch.profiler.profile`` around the loop): the
range lands in the profiler's Chrome trace as a ``user_annotation`` event
on the same clock as the device ops.  With no profiler running it returns
one shared null context and records nothing: the check is one module
attribute read, where a ``record_function`` entered with no profiler
running still costs some microseconds a span.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` in the running profiler's
    trace, or the shared null context when no profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)
