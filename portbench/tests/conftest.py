"""A cell of the benchmark at a size the CPU runs in seconds: the
stand-in at about 2,400 triangles and 3 materials with 16x16 maps, a
96x64 surface and a 256x256 shadow map, 5 warm-up frames and 2 sampled
frames."""

import json
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
REPO = ROOT.parent


@pytest.fixture
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.fixture
def tiny_config():
    config = json.loads((ROOT / "configs" / "sponza-1080p.json").read_text())
    config.update(name="tiny", width=96, height=64, shadow_map=256,
                  texture_size=16,
                  geometry=dict(config["geometry"], target_tris=3000,
                                num_materials=3),
                  expect={"triangles": 2448, "materials": 3})
    return config


def tiny_mix(name: str) -> dict:
    mix = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    mix.update(warmup_frames=5, samples=2)
    return mix


@pytest.fixture
def tiny_cell():
    return {"name": "tiny.fly-fresh", "config": "tiny",
            "traffic": "fly-fresh", "chips": 1}
