"""The paper's own experiment config (§5.1): logistic/Poisson regression
(``repro/configs/logistic_synthetic.py`` counterpart)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class RegressionConfig:
    model: str = "logistic"   # logistic | poisson | linear
    p: int = 10               # parameter dimension (paper: 10, 20)
    m: int = 500              # node machines (paper: 500..5000)
    n: int = 4000             # samples per machine (N = (m+1)*n)
    rho: float = 0.6          # Toeplitz correlation of X
    alpha: float = 0.0        # Byzantine fraction (paper: 0, 0.10)
    attack: str = "scale"     # scaling attack, factor -3 (paper §5.1)
    attack_factor: float = -3.0


CONFIG = RegressionConfig()
