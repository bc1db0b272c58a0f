"""The paper's own workload as a config: row-granulized matmul over the
9-machine heterogeneous testbed (P-II/III/IV mix, 100 Mbps Ethernet).

Copy of ``repro/configs/paper_matmul.py``; the port's ``chip_smoke.py``
runs the paper's experiment from it.  Exposed here so the workload is
addressable like the LM archs.
"""

import dataclasses

from ..core.homogenization import OverheadModel
from ..core.simulate import PAPER_MACHINES

ARCH = "paper-matmul"


@dataclasses.dataclass(frozen=True)
class PaperMatmulConfig:
    sizes: tuple[int, ...] = (200, 400, 600, 800, 1000)   # square matrix sizes
    machines: tuple[float, ...] = PAPER_MACHINES          # performance factors
    overhead_m: float = 20.0                              # paper's slope M
    ref_size: int = 800                                   # unit-work reference

    def overhead(self) -> OverheadModel:
        return OverheadModel(m=self.overhead_m)


def config() -> PaperMatmulConfig:
    return PaperMatmulConfig()
