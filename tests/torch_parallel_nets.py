"""The programs of the port's multi-rank tests, built through either
package's fluid API (the same script): tests/test_torch_parallel_ranks.py
builds each with the JAX package for its SPMD oracle, and
tests/torch_parallel_worker.py with the port on every rank. Each function
takes (fluid, cfg) and returns (main, startup, loss); `shard(fluid, main,
cfg)` applies the case's mesh annotations (the mesh itself is the
caller's)."""

import numpy as np

LM = {"seqlen": 16, "n_layer": 1, "d_model": 32, "n_head": 2, "vocab": 64,
      "batch": 8, "lr": 1e-2}
# tests/test_moe.py's expert-parallel net: 16 features, 8 experts of
# hidden 32, a batch of 64 tokens (capacity 10 an expert), SGD 0.02
MOE = {"dim": 16, "experts": 8, "hidden": 32, "batch": 64, "lr": 0.02}
TABLE = {"rows": 64, "dim": 8, "slots": 3, "batch": 8, "lr": 0.1}


def _momentum(fluid):
    return fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9)


def mlp(fluid, cfg):
    """tests/test_multi_device.py's MLP (fc 32 relu, fc 4, softmax cross
    entropy), Momentum."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.fc(input=x, size=32, act="relu",
                            param_attr=fluid.ParamAttr(name="tp_w1"))
        logits = fluid.layers.fc(input=h, size=4,
                                 param_attr=fluid.ParamAttr(name="tp_w2"))
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        _momentum(fluid).minimize(loss)
    return main, startup, loss


def conv(fluid, cfg):
    """A conv -> batch_norm -> relu -> pool -> fc net (the conv program of
    tests/test_multi_device.py's family): synchronized batch-norm
    statistics over the split batch."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        c = fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                padding=1)
        b = fluid.layers.batch_norm(c, act="relu")
        p = fluid.layers.pool2d(b, pool_size=2, pool_stride=2,
                                pool_type="max")
        logits = fluid.layers.fc(input=p, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        acc = fluid.layers.accuracy(fluid.layers.softmax(logits), y)
        _momentum(fluid).minimize(loss)
    main._acc = acc
    return main, startup, loss


def lm(fluid, cfg):
    """transformer_lm at LM's size, Momentum."""
    t = LM["seqlen"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        tok = fluid.layers.data(name="tok", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        lab = fluid.layers.data(name="lab", shape=[-1, t], dtype="int64",
                                append_batch_size=False)
        loss = fluid.models.transformer_lm(
            tok, lab, vocab_size=LM["vocab"], d_model=LM["d_model"],
            n_head=LM["n_head"], n_layer=LM["n_layer"],
            use_flash=cfg.get("use_flash", False))
        _momentum(fluid).minimize(loss)
    return main, startup, loss


def table(fluid, cfg):
    """A DLRM-like tower over one embedding table (is_sparse), Momentum."""
    c = TABLE
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        ids = fluid.layers.data(name="ids", shape=[c["slots"]],
                                dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(
            ids, size=[c["rows"], c["dim"]], is_sparse=True,
            param_attr=fluid.ParamAttr(name="emb_table"))
        flat = fluid.layers.reshape(emb, shape=[-1, c["slots"] * c["dim"]])
        h = fluid.layers.fc(input=flat, size=16, act="relu")
        logits = fluid.layers.fc(input=h, size=2)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        fluid.optimizer.Momentum(learning_rate=c["lr"],
                                 momentum=0.9).minimize(loss)
    return main, startup, loss


def unruled(fluid, cfg):
    """An op that reduces the batch with no rule for it (l1_norm of the
    fed batch): a sharded run must raise, naming it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        out = main.global_block().create_var(name="l1", dtype="float32",
                                             shape=[1])
        main.global_block().append_op(type="l1_norm", inputs={"X": [x]},
                                      outputs={"Out": [out]})
    return main, startup, out


def moe(fluid, cfg):
    """tests/test_moe.py's TestExpertParallel net: sparse_moe, fc to one
    output, mean squared error, SGD."""
    c = MOE
    main, startup = fluid.Program(), fluid.Program()
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[c["dim"]], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.sparse_moe(x, num_experts=c["experts"],
                                    hidden_size=c["hidden"])
        pred = fluid.layers.fc(input=h, size=1,
                               param_attr=fluid.ParamAttr(name="mo_w"))
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGDOptimizer(learning_rate=c["lr"]).minimize(loss)
    return main, startup, loss


def random_ops(fluid, cfg):
    """The batch-size-like random ops and nce over a fed batch, trained a
    step with SGD (nce's weights take the negatives' gradients): the
    values each draws are fetched (main._fetch)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 5
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[16], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        u = fluid.layers.uniform_random_batch_size_like(x, shape=[-1, 16])
        g = fluid.layers.gaussian_random_batch_size_like(x, shape=[-1, 16],
                                                         std=0.5)
        h = fluid.layers.elementwise_add(
            x, fluid.layers.elementwise_mul(u, g))
        cost = fluid.layers.nce(input=h, label=y, num_total_classes=32,
                                num_neg_samples=5)
        loss = fluid.layers.mean(cost)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    main._fetch = [u, g, cost]
    return main, startup, loss


def conv_bn(fluid, cfg):
    """A 3-channel conv -> batch_norm -> relu -> pool -> fc net: its conv
    is not K4's (3 input channels), so its bn + relu is a K6 window; in
    O2 (cfg amp) the window takes K6 (its plain version on the CPU), in
    f32 it falls back (kernel_dtype). cfg bare: the batch norm reads the
    fed images cast to bf16 instead of the conv's output, so that its
    input is the same bits on every rank and on one (a conv on the card
    may round another batch size's rows otherwise)."""
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    with fluid.unique_name.guard(), fluid.program_guard(main, startup):
        img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        c = fluid.layers.cast(img, "bfloat16") if cfg.get("bare") else \
            fluid.layers.conv2d(img, num_filters=8, filter_size=3,
                                padding=1)
        b = fluid.layers.batch_norm(c, act="relu")
        p = fluid.layers.pool2d(b, pool_size=2, pool_stride=2,
                                pool_type="max")
        logits = fluid.layers.fc(input=p, size=4)
        loss = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, y))
        opt = _momentum(fluid)
        if cfg.get("amp"):
            opt = fluid.amp.decorate(opt, level="O2")
        opt.minimize(loss)
    bn = [op for op in main.global_block().ops if op.type == "batch_norm"][0]
    main._fetch = [main.global_block().var(bn.desc.output(s)[0])
                   for s in ("SavedMean", "SavedVariance", "Y")]
    return main, startup, loss


BUILDERS = {"mlp": mlp, "conv": conv, "lm": lm, "table": table,
            "unruled": unruled, "moe": moe, "random_ops": random_ops,
            "conv_bn": conv_bn}


def shard(fluid, main, cfg):
    """The case's annotations on `main` (whose `_mesh` is set)."""
    how = cfg.get("shard")
    if how == "fc":
        fluid.parallel.shard_fc_params(main, axis=cfg.get("axis", "mp"))
    elif how == "row":
        fluid.parallel.shard_parameter(main, "tp_w1", ("mp", None))
        fluid.parallel.shard_parameter(main, "tp_w2", ("mp", None))
    elif how == "zero":
        fluid.parallel.shard_all_params_zero(main, axis="dp", min_size=8)
    elif how == "plan":
        fluid.parallel.planner.plan(main)
    elif how == "table":
        fluid.parallel.shard_table(main, "emb_table", cfg.get("axis", "dp"))
    elif how == "ep":
        # the experts over 'ep' (W1, W2 are the 3-D parameters); form (b)
        # also splits the batch over it
        for p in main.global_block().all_parameters():
            if p.shape is not None and len(p.shape) == 3:
                fluid.parallel.shard_parameter(main, p.name,
                                               ("ep", None, None))
        if cfg.get("ep_batch"):
            for n in ("x", "y"):
                fluid.parallel.shard_feed(main, n, ("ep", None))


def feeds(name, steps, seed=0):
    """`steps` global batches of the case's program."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        if name == "moe":
            c = MOE
            w = np.random.RandomState(seed + 100).randn(c["dim"], 1)
            x = rng.randn(c["batch"], c["dim"]).astype(np.float32)
            out.append({"x": x, "y": (x @ w).astype(np.float32)})
        elif name == "random_ops":
            out.append({"x": rng.randn(8, 16).astype(np.float32),
                        "y": rng.randint(0, 32, (8, 1)).astype(np.int64)})
        elif name == "conv_bn":
            out.append({"img": rng.randn(8, 3, 8, 8).astype(np.float32),
                        "y": rng.randint(0, 4, (8, 1)).astype(np.int64)})
        elif name in ("mlp", "unruled"):
            out.append({"x": rng.randn(8, 16).astype(np.float32),
                        "y": rng.randint(0, 4, (8, 1)).astype(np.int64)})
        elif name == "conv":
            out.append({"img": rng.randn(8, 3, 8, 8).astype(np.float32),
                        "y": rng.randint(0, 4, (8, 1)).astype(np.int64)})
        elif name == "lm":
            t = LM["seqlen"]
            tok = rng.randint(0, LM["vocab"], (LM["batch"], t + 1))
            out.append({"tok": tok[:, :-1].astype(np.int64),
                        "lab": tok[:, 1:].astype(np.int64)})
        elif name == "table":
            c = TABLE
            out.append({"ids": rng.randint(0, c["rows"], (c["batch"],
                                                          c["slots"]))
                        .astype(np.int64),
                        "y": rng.randint(0, 2, (c["batch"], 1))
                        .astype(np.int64)})
    return out
