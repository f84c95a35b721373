"""Layers DSL (reference: python/paddle/fluid/layers/__init__.py)."""

from . import math_op_patch  # noqa: F401  (patches Variable operators)
from .io import *            # noqa: F401,F403
from .tensor import *        # noqa: F401,F403
from .nn import *            # noqa: F401,F403
from .sequence import *      # noqa: F401,F403
from .control_flow import *  # noqa: F401,F403
from .ops import *           # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403

from . import (io, tensor, nn, ops, sequence, control_flow,  # noqa: F401
               learning_rate_scheduler, detection)
