"""The paper's own workload: the ALPHA-PIM graph engine configuration.

Not an LM: this config drives the distributed semiring graph engine
(core/ + graphs/) as the paper runs it: datasets, algorithms, the
partitioning strategy and the adaptive SpMSpV/SpMV switch. The paper's
best layout is CSC-2D."""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GraphRunConfig:
    datasets: Tuple[str, ...] = (
        "A302", "as00", "ca-Q", "cit-HP", "e-En", "face", "g-18",
        "loc-b", "p2p-24", "r-TX", "s-S02", "s-S11", "flk-E")
    algorithms: Tuple[str, ...] = ("bfs", "sssp", "ppr")
    partitioning: str = "2d"          # row | col | 2d  (paper: CSC-2D best)
    fmt: str = "csc"                  # coo | csr | csc
    adaptive: bool = True             # SpMSpV <-> SpMV switching (paper §4.2)
    block: Tuple[int, int] = (128, 128)   # BSR tile
    max_iters: int = 64
    ppr_alpha: float = 0.85
    scale: float = 0.05               # dataset scale factor for CPU runs


CONFIG = GraphRunConfig()
