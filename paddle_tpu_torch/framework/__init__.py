from .desc import (BlockDesc, BlockRef, BlocksRef, OpDesc, ProgramDesc,
                   VarDesc, VarType)
from .framework import (Block, Operator, Parameter, Program, Variable,
                        GRAD_VAR_SUFFIX, convert_dtype, default_main_program,
                        grad_var_name,
                        default_startup_program, in_block, op_external_reads,
                        program_guard,
                        switch_main_program, switch_startup_program)
from . import unique_name
