from .pss import kelemen_mutate, KelemenParams
from .stratified import stratified_jitter
