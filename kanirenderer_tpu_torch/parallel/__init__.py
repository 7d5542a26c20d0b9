"""Row-band rendering over several ranks or bands (parallel/mesh.py)."""

from kanirenderer_tpu_torch.parallel.mesh import (Collectives, Mesh,
                                                  deinterleave_rows,
                                                  dryrun_multichip,
                                                  make_mesh,
                                                  render_frame_sharded,
                                                  run_ranks)

__all__ = ["Collectives", "Mesh", "deinterleave_rows", "dryrun_multichip",
           "make_mesh", "render_frame_sharded", "run_ranks"]
