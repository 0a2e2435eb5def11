from .path import IntegratorGradientPath
from .reconnect import IntegratorGradientPathReconnect
from .recons import (
    uniform_poisson_reconstruction, weighted_poisson_reconstruction,
    bagging_poisson_reconstruction,
)
