"""The paper's own workload: the 539 x 170897 job-candidate bipartite
sparse matrix (kariyer.net).  The port's own copy of the reference's
``repro.configs.ranky_paper`` (the two packages share no module)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RankyPaperConfig:
    rows: int = 539
    cols: int = 170_897
    density: float = 5e-4
    blocks: tuple = (2, 3, 4, 8, 10, 16, 32, 64, 128)
    seed: int = 2020


def config() -> RankyPaperConfig:
    return RankyPaperConfig()


def smoke_config() -> RankyPaperConfig:
    return RankyPaperConfig(rows=48, cols=4096, density=2e-3, blocks=(2, 4, 8))
