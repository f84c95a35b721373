"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu for one NVIDIA H100.

The JAX package `paddle_tpu` stays beside it as the reference; this package
imports `torch` and numpy, never `jax` and nothing of `paddle_tpu`. Module
and public names follow paddle_tpu's, so each file has an obvious
counterpart. The port serves and trains image classifiers and the
transformer language model: Program/Block IR, the layers DSL for ResNet
and the transformer, AMP O1/O2 and int8 serving (O3, quant.py),
checkpoint and inference-model save/load (io.py), append_backward with
generic and explicit grad ops, an Executor that graphs each step on the
card, the conv -> batch_norm [-> act] windows (the inference fold and
the training kernels), the ServingEngine, and eleven hand-written kernels:
K1-K4 and K11, the conv forward, grad-input, grad-filter, conv+statistics
and int8 conv kernels in CUDA C++ for sm_90a (ops/conv_cuda.py); K5-K6,
the batch-norm kernels, K5 in Triton and K6 in CUDA C++ (ops/bn_cuda.py);
K7-K10, the
flash-attention forward, dQ, dK/dV and the ring's unnormalized forward
block in CUDA C++ (ops/attention_cuda.py), the last for ring attention
over an 'sp' mesh of torch.distributed ranks (parallel/). Input: the
reader decorators and creators (reader/), `batch`, the datasets the book
chapters read (dataset/, synthetic surrogates unless real files are
cached), RecordIO files (recordio.py over native/recordio.cc), DataFeeder,
the DoubleBufferedFeeder that stages batches on the card from a copy
stream (reader/pipeline.py), and Executor.run_steps, K steps a call.
Sequences: LoDTensor feeds padded with their lengths beside them
(executor.py), the sequence ops and the LSTM/GRU (ops/sequence_ops.py,
layers/sequence.py), dropout, and the imdb, movielens and sentiment
datasets. Control flow: sub-blocks, While / ConditionalBlock / IfElse /
Switch / StaticRNN / DynamicRNN with the grads of while and
conditional_block, tensor arrays, beam search, the linear-chain CRF and
CTC (ops/control_flow_ops.py, layers/control_flow.py), and the conll05,
wmt14 and wmt16 datasets. The training front end: the optimizer family
(SGD, Momentum, Adagrad, Adam, Adamax, DecayedAdagrad, Adadelta, RMSProp,
Ftrl, and the proximal ops), ModelAverage, gradient clipping by value,
norm and global norm (clip.py, the global norm published as the
optimizer_global_norm gauge), L1 and L2 decay, the learning-rate schedules
on the global step counter (layers/learning_rate_scheduler.py), the
Variable operators (layers/math_op_patch.py), calc_gradient, the tensor
and loss op families, the save/load ops, the in-program reader layers
(layers/io.py: open_recordio_file, shuffle, batch, multi_pass,
double_buffer, read_file, pulled by Executor.run) and the mq2007 dataset.
Memory and static analysis: device-memory accounting, measured and static
peaks, the headroom model and OOM forensics (memory.py), the program
verifier (analysis/: shapes, dataflow, fast-path preflight) that admits
served programs, the flag registry (flags.py), the typed errors
(errors.py) and the RNN weight converters (compat.py). The numeric-health
plane: the inspector's tensor_stats probes (T1, the port's Triton
kernel, ops/stats_cuda.py), check_nan_inf raising NonFiniteError with the
first non-finite op found by bisection, the gradient audit and the crash
flight recorder (inspector.py), the training-dynamics observatory
(dynamics.py), the program printer (debugger.py), and the executor's step
telemetry with its exports: Prometheus text, the JSONL step log, chrome
traces (telemetry.py, tracing.py).

Entry points run on CUDAPlace(0) unless the caller passes CPUPlace().
"""

from .framework import (Program, Block, Variable, Parameter, program_guard,
                        default_main_program, default_startup_program,
                        switch_main_program, switch_startup_program,
                        unique_name)
from .executor import (CPUPlace, CUDAPlace, TPUPlace, Executor, LoDTensor,
                       Scope, global_scope, scope_guard)
from . import ops
from . import layers
from . import initializer
from .initializer import (Constant, ConstantInitializer, Normal,
                          NormalInitializer, Uniform, UniformInitializer,
                          Xavier, XavierInitializer, MSRA, MSRAInitializer)
from .param_attr import ParamAttr
from . import amp
from . import backward
from .backward import append_backward, calc_gradient
from . import regularizer
from . import clip
from . import optimizer
from .optimizer import (SGD, SGDOptimizer, Momentum, MomentumOptimizer,
                        Adagrad, AdagradOptimizer, Adam, AdamOptimizer,
                        Adamax, AdamaxOptimizer, DecayedAdagrad,
                        DecayedAdagradOptimizer, Adadelta, AdadeltaOptimizer,
                        RMSProp, RMSPropOptimizer, Ftrl, FtrlOptimizer)
from . import average
from . import io
from . import quant
from . import interop
from . import models
from . import parallel
from .parallel import transpiler
from .parallel.transpiler import (DistributeTranspiler, memory_optimize,
                                  release_memory)
from . import serving
from .data_feeder import DataFeeder
from . import nets
from . import reader
from . import dataset
from . import metrics
from . import recordio
from .minibatch import batch
from . import errors
from . import flags
from . import compat
from . import memory
from . import analysis
from . import debugger
from . import inspector
from . import dynamics

__version__ = "0.1.0"
