"""Dataflow checks over the root block (the `dataflow` pass; the port's
copy of paddle_tpu/analysis/dataflow.py).

Single forward walk for def/use ordering and write-after-write, one
backward liveness sweep from the fetch set for dead code, then the
program-attribute cross-checks: param<->grad pairing recorded by
append_backward (`program._grad_param_pairs`), the fetch of persistable
state the program updates, and sparse-gradient reachability
(`program._sparse_grad_names` consumers vs executor._SPARSE_AWARE_OPS, the
port's sparse-aware ops — the densify cliff the runtime counter
`sparse_densify_fallback_total` only reports after the fact).

Severity policy: use-before-def where a later op DOES produce the var
is an error (the trace will read garbage or throw); an input nothing
ever produces is only a warning when the caller pinned the feed list
(without it, any producer-less var is presumed feedable). Dead ops,
WAW, donated-fetch and densify boundaries are warnings — programs run
fine with them, they just waste memory or FLOPs. The code
`donated-fetch` keeps the JAX package's name; in the port the updated
state is written in place (a graphed step's state buffers), so a fetch of
it costs a copy and, within a run_steps window, shows the last step's
value.
"""

from __future__ import annotations

# ops whose value is their side effect — never dead, and their outputs
# (save paths, print passthroughs) don't need to reach the fetch set
_SIDE_EFFECT_OPS = frozenset({
    "save", "save_combine", "print", "feed", "fetch", "while",
    "conditional_block", "write_to_array", "beam_search_decode",
})


def _reads(op):
    return set(op.input_arg_names)


def _writes(op):
    return set(op.output_arg_names)


def run(pctx):
    block = pctx.block
    ops = pctx.ops
    declared = set(block.desc.vars)
    persistable = {n for n, v in block.desc.vars.items() if v.persistable}

    producers = {}  # var -> [op indices that write it]
    for i, op in enumerate(ops):
        for n in _writes(op):
            producers.setdefault(n, []).append(i)

    feeds = pctx.feeds
    if feeds is None:
        # presume any declared producer-less var is a feed
        feeds = {n for n in declared if n not in producers}

    # --- use-before-def + write-after-write (one forward walk) ---
    defined = set(feeds) | persistable
    last_write = {}  # var -> (op index, read since?)
    for i, op in enumerate(ops):
        for n in sorted(_reads(op)):
            if n in last_write:
                last_write[n] = (last_write[n][0], True)
            if n in defined or n not in declared:
                continue
            later = [j for j in producers.get(n, []) if j >= i]
            if later and later[0] == i and n in _writes(op):
                # in-place accumulator (write_to_array appending to the
                # array it reads, increment counters): the op is its own
                # only producer — the value starts implicitly empty/zero,
                # not garbage, so this is not a use-before-def
                pass
            elif later:
                pctx.emit(
                    "error", "use-before-def",
                    f"reads '{n}' which is only produced later, by op "
                    f"{later[0]} '{ops[later[0]].type}'",
                    op_index=i, var=n,
                    hint="reorder the ops: the producer must be appended "
                         "before this consumer")
            elif pctx.feeds is not None and not n.endswith("@GRAD"):
                # @GRAD names are optional cotangents: zero when absent
                pctx.emit(
                    "warning", "undefined-input",
                    f"reads '{n}' which no op produces and the feed list "
                    f"does not include", op_index=i, var=n)
            defined.add(n)  # one diagnostic per var, not per consumer
        for n in sorted(_writes(op)):
            prev = last_write.get(n)
            if prev is not None and not prev[1] and n not in _reads(op):
                pctx.emit(
                    "warning", "write-after-write",
                    f"overwrites '{n}' before anyone read the value op "
                    f"{prev[0]} '{ops[prev[0]].type}' stored there",
                    op_index=i, var=n,
                    hint="dead store: drop the first writer or give the "
                         "second a fresh output var")
            last_write[n] = (i, False)
            defined.add(n)

    # --- dead code relative to the fetch set (backward liveness) ---
    fetches = set(pctx.fetches)
    if fetches:
        needed = set(fetches)
        live = [False] * len(ops)
        for i in range(len(ops) - 1, -1, -1):
            op = ops[i]
            outs = _writes(op)
            if (outs & needed or op.type in _SIDE_EFFECT_OPS
                    or outs & persistable):  # state updates are the point
                live[i] = True
                needed |= _reads(op)
        for i, op in enumerate(ops):
            if not live[i]:
                pctx.emit(
                    "warning", "dead-op",
                    f"no path from any output {sorted(_writes(op))} to "
                    f"the fetch set", op_index=i,
                    hint="Program.prune(fetches) drops it, or fetch one "
                         "of its results")
        read_anywhere = set()
        for op in ops:
            read_anywhere |= _reads(op)
        for n in sorted(declared - read_anywhere - fetches - persistable):
            if n in producers and all(not live[j] for j in producers[n]):
                continue  # already covered by the dead-op diagnostic
            if n in producers:
                pctx.emit("info", "dead-var",
                          f"'{n}' is computed but never read or fetched",
                          var=n)

    # --- donated persistable state vs fetch ---
    written = set()
    for op in ops:
        written |= _writes(op)
    for n in sorted(fetches):
        if n in persistable and n in written:
            pctx.emit(
                "warning", "donated-fetch",
                f"fetches persistable '{n}', which is also updated "
                f"in-program: its buffer is updated in place, so the "
                f"fetch costs an extra device copy and within a "
                f"run_steps window only the last step's value is "
                f"visible", var=n,
                hint="fetch a non-persistable snapshot (assign the value "
                     "to a fresh var) or read the param from the scope "
                     "after run()")

    # --- param<->grad pairing (append_backward's record) ---
    sparse = set(getattr(pctx.program, "_sparse_grad_names", None) or ())
    pairs = getattr(pctx.program, "_grad_param_pairs", None) or []
    from ..framework.desc import VarType
    for pname, gname in pairs:
        pv = block.desc.vars.get(pname)
        gv = block.desc.vars.get(gname)
        if pv is None or gv is None:
            pctx.emit("error", "param-grad-pairing",
                      f"recorded pair ('{pname}', '{gname}') names a var "
                      f"missing from the block", var=pname)
            continue
        if (gname in sparse or gv.type == VarType.SELECTED_ROWS
                or pv.shape is None or gv.shape is None):
            continue
        from .infer import shapes_agree
        if not shapes_agree(pv.shape, gv.shape):
            pctx.emit(
                "error", "param-grad-shape",
                f"param '{pname}' {list(pv.shape)} vs grad '{gname}' "
                f"{list(gv.shape)}", var=gname,
                hint="a desc edit between append_backward and the "
                     "optimizer broke the pairing")
        if gname not in {n for op in ops for n in _reads(op)}:
            pctx.emit("warning", "unused-grad",
                      f"gradient '{gname}' of param '{pname}' is computed "
                      f"but no optimizer op consumes it", var=gname,
                      hint="pass the param to minimize()'s parameter_list "
                           "or drop it from the backward")

    # --- sparse-gradient reachability ---
    if sparse:
        from ..executor import _SPARSE_AWARE_OPS
        for i, op in enumerate(ops):
            hit = sorted(_reads(op) & sparse)
            if hit and op.type not in _SPARSE_AWARE_OPS:
                pctx.emit(
                    "warning", "sparse-densify",
                    f"consumes SelectedRows gradient '{hit[0]}' but has "
                    f"no sparse kernel: the rows densify to the full "
                    f"table at this boundary (O(rows) -> O(table))",
                    op_index=i, var=hit[0],
                    hint="keep the sparse grad chain inside the sparse-aware "
                         "ops (sum, sgd/momentum/adam, ...) or "
                         "accept the densify (counted at runtime by "
                         "sparse_densify_fallback_total)")
