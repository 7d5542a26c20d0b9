"""Frame-time ring buffer (reference src/frametime.rs:18-31).

256-entry host-side ring of frame times in milliseconds, feeding the Debug
overlay graph (passes/overlay.frame_time_graph) and the FPS report.
"""

from __future__ import annotations

import numpy as np


class FrameTimeGraph:
    def __init__(self, max_points: int = 256):
        self.max_points = max_points
        self.buffer = np.zeros(max_points, np.float32)
        self.current_index = 0

    def update(self, dt_seconds: float) -> None:
        self.buffer[self.current_index] = dt_seconds * 1000.0
        self.current_index = (self.current_index + 1) % self.max_points

    @property
    def mean_ms(self) -> float:
        nz = self.buffer[self.buffer > 0]
        return float(nz.mean()) if len(nz) else 0.0

    @property
    def fps(self) -> float:
        m = self.mean_ms
        return 1000.0 / m if m > 0 else 0.0
