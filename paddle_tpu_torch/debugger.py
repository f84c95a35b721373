"""Program debugging: pretty printer + Graphviz DOT rendering (the port's
copy of paddle_tpu/debugger.py, pure Python over the IR, so the same
program prints the same text and DOT from either package; reference:
python/paddle/fluid/debuger.py pprint_program_codes / draw_block_graphviz,
python/paddle/fluid/graphviz.py, net_drawer.py).

`pprint_program` renders blocks as pseudo-code (vars with shapes/dtypes,
ops as calls); `draw_program` emits a Graphviz DOT graph (ops as boxes,
variables as ellipses, parameters highlighted) and optionally invokes
`dot` when available."""

from __future__ import annotations

import shutil
import subprocess
import warnings
from typing import Optional

__all__ = ["pprint_program", "draw_program"]


def _fmt_var(v) -> str:
    shape = "x".join(str(d) for d in (v.shape or [])) or "?"
    extra = ""
    if getattr(v, "persistable", False):
        extra += " persistable"
    if getattr(v, "lod_level", 0):
        extra += f" lod={v.lod_level}"
    return f"{v.name}: {v.dtype or '?'}[{shape}]{extra}"


def pprint_program(program, print_fn=print):
    """Pseudo-code program dump (reference debuger.py:131
    pprint_program_codes)."""
    for block in program.blocks:
        print_fn(f"// block {block.idx}"
                 + (f" (parent {block.parent_idx})"
                    if getattr(block, 'parent_idx', -1) not in (-1, None)
                    else ""))
        for name in sorted(block.desc.vars):
            v = block.desc.var(name)
            print_fn(f"  var {_fmt_var(v)}")
        for op in block.ops:
            outs = ", ".join(op.output_arg_names)
            ins = ", ".join(op.input_arg_names)
            attrs = {k: v for k, v in op.desc.attrs.items()
                     if not k.startswith("__")}
            a = ", ".join(f"{k}={v!r}" for k, v in sorted(attrs.items())
                          if not hasattr(v, "idx"))
            print_fn(f"  {outs or '()'} = {op.type}({ins}"
                     + (f" | {a}" if a else "") + ")")
        print_fn("")


def draw_program(program, path: Optional[str] = None, block_idx: int = 0,
                 render: bool = True) -> str:
    """Graphviz DOT for one block (reference debuger.py:33
    draw_block_graphviz, graphviz.py): op nodes are boxes, variables are
    ellipses, parameters are shaded. Returns the DOT source; writes
    `path` (.dot) and renders `<path>.pdf`/`.png` when `dot` exists and
    render=True."""
    block = program.block(block_idx)
    from .framework.framework import Parameter

    lines = ["digraph program {", '  rankdir=TB;',
             '  node [fontsize=10];']
    var_ids = {}

    def var_node(name):
        if name in var_ids:
            return var_ids[name]
        nid = f"var_{len(var_ids)}"
        var_ids[name] = nid
        v = block.desc.var(name) if block.desc.has_var(name) else None
        label = name if v is None else _fmt_var(v)
        is_param = isinstance(block.vars.get(name), Parameter)
        style = 'style=filled, fillcolor="#c9e4ca"' if is_param else \
            'style=filled, fillcolor="#f0f0f0"'
        lines.append(f'  {nid} [shape=ellipse, label="{label}", {style}];')
        return nid

    for i, op in enumerate(block.ops):
        op_id = f"op_{i}"
        lines.append(
            f'  {op_id} [shape=box, label="{op.type}", '
            f'style=filled, fillcolor="#a8d5e5"];')
        for name in op.input_arg_names:
            lines.append(f"  {var_node(name)} -> {op_id};")
        for name in op.output_arg_names:
            lines.append(f"  {op_id} -> {var_node(name)};")
    lines.append("}")
    dot = "\n".join(lines)

    if path:
        with open(path, "w") as f:
            f.write(dot)
        if render and shutil.which("dot"):
            for fmt in ("pdf", "png"):
                # a broken graphviz install (dot present but exiting
                # non-zero, or failing to exec) must not take down the
                # caller: the .dot source above is already on disk, so warn
                # and fall back to it
                try:
                    proc = subprocess.run(
                        ["dot", f"-T{fmt}", path, "-o", f"{path}.{fmt}"],
                        check=False, capture_output=True)
                except OSError as e:
                    warnings.warn(
                        f"graphviz 'dot' could not be executed ({e}); "
                        f"DOT source written to {path} only", RuntimeWarning)
                    break
                if proc.returncode != 0:
                    err = proc.stderr.decode("utf-8", "replace").strip()
                    warnings.warn(
                        f"'dot -T{fmt}' exited with status {proc.returncode}"
                        + (f": {err[:200]}" if err else "")
                        + f"; DOT source written to {path} only",
                        RuntimeWarning)
                    break
    return dot
