from .ao import IntegratorAO
from .common import render, mis_power, mis_balance
from .path import (IntegratorPathTracing, STRATEGY_ALL, STRATEGY_BSDF,
                   STRATEGY_EMITTER)
