"""DESIRE: a JAX/XLA framework for DESIRE
(Lee et al., CVPR'17) — stochastic multi-agent trajectory forecasting with
CVAE sample generation and IOC ranking-and-refinement.

Built from scratch against the capability spec of the tdavchev/DESIRE
reference (see SURVEY.md); not a port.
"""

from desire.config import DesireConfig

__version__ = "0.1.0"
__all__ = ["DesireConfig", "__version__"]
