from .pssmlt import IntegratorPSSMLT
from .erpt import IntegratorERPT
from .smcmc import IntegratorSMCMC
