from .ao import IntegratorAO
from .common import (render, render_adaptive, render_splat, mis_power,
                     mis_balance, SplattingIntegrator)
from .direct import IntegratorDirect
from .light import IntegratorLightTracing
from .meta import IntegratorAverage, IntegratorEqualTime
from .path import (IntegratorPathTracing, STRATEGY_ALL, STRATEGY_BSDF,
                   STRATEGY_EMITTER, STRATEGY_NAIVE)
from .plane_single import IntegratorSinglePlane
from .point_normal import IntegratorPointNormal
from .vol_primitives import IntegratorVolPrimitives
from .vpl import IntegratorVPL
