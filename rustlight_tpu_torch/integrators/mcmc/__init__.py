from .pssmlt import IntegratorPSSMLT
from .erpt import IntegratorERPT
