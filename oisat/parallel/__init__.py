"""Multi-device scaling: mesh construction + sharded analysis steps.

The reference scales with joblib process fan-out over input files and one
HPC batch job per month (SURVEY.md §2 "Parallelism A/B"); the device
equivalents here are:

  * granule-batch data parallelism: the (G, H, W) granule stack is sharded
    over an 'obs' mesh axis,
  * spatial partitioning: the (H, W) analysis grid is sharded over a 'grid'
    mesh axis,

with XLA inserting the collectives (the monthly reduction over G and the
global mean-AK curve reductions become cross-device sums).  Cells are
independent, so communication is limited to those scalar reductions.
"""

from oisat.parallel.mesh import make_mesh
from oisat.parallel.analysis import make_analysis_step, analysis_step

__all__ = ["make_mesh", "make_analysis_step", "analysis_step"]
