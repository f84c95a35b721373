"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package `paddle_tpu` stays beside it as the reference; this package
imports `torch` and numpy, never `jax` and nothing of `paddle_tpu`. Module
and public names follow paddle_tpu's, so each file has an obvious
counterpart. The port serves and trains image classifiers and the
transformer language model: Program/Block IR, the layers DSL for ResNet
and the transformer, AMP O1/O2 and int8 serving (O3, quant.py),
checkpoint and inference-model save/load (io.py), append_backward with
generic and explicit grad ops, the SGD/Momentum/Adam optimizers, an eager
Executor, the conv -> batch_norm [-> act] windows (the inference fold and
the training kernels), the ServingEngine, and eleven hand-written kernels:
K1-K4 and K11, the conv forward, grad-input, grad-filter, conv+statistics
and int8 conv kernels in CUDA C++ for sm_90a (ops/conv_cuda.py); K5-K6,
the batch-norm kernels in Triton (ops/bn_cuda.py); K7-K10, the
flash-attention forward, dQ, dK/dV and the ring's unnormalized forward
block in CUDA C++ (ops/attention_cuda.py), the last for ring attention
over an 'sp' mesh of torch.distributed ranks (parallel/).

Entry points run on CUDAPlace(0) unless the caller passes CPUPlace().
"""

from .framework import (Program, Block, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        switch_main_program, switch_startup_program,
                        unique_name)
from .executor import (CPUPlace, CUDAPlace, TPUPlace, Executor, Scope,
                       global_scope, scope_guard)
from . import ops
from . import layers
from . import initializer
from .initializer import (Constant, ConstantInitializer, Normal,
                          NormalInitializer, Uniform, UniformInitializer,
                          Xavier, XavierInitializer, MSRA, MSRAInitializer)
from .param_attr import ParamAttr
from . import amp
from . import backward
from .backward import append_backward
from . import regularizer
from . import clip
from . import optimizer
from . import io
from . import quant
from . import interop
from . import models
from . import parallel
from . import serving

__version__ = "0.1.0"
