"""Op corpus: importing this package registers every op lowering the port
has."""

from . import registry
from . import basic_ops      # noqa: F401
from . import math_ops       # noqa: F401
from . import nn_ops         # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import sequence_ops   # noqa: F401
from . import control_flow_ops  # noqa: F401
from . import misc_ops       # noqa: F401
from . import beam_search_ops  # noqa: F401
from . import crf_ops        # noqa: F401
from . import ctc_ops        # noqa: F401
from . import eval_ops       # noqa: F401
from . import extra_ops      # noqa: F401
from . import vision_ops     # noqa: F401
from . import detection_ops  # noqa: F401
from . import fusion         # noqa: F401

from .registry import register, op, get, try_get
