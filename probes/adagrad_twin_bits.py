#!/usr/bin/env python3
"""Where the online phase's sparse_adagrad twin parts, card against CPU:

    python3 probes/adagrad_twin_bits.py [--steps 8]

``chip_smoke.py``'s ``online`` phase trains a sparse_adagrad twin of
bench's online model (2^10 dims, 4 dense + 4 categorical columns, step
0.05) incrementally on the card and on the CPU and holds the two tables
within ``_theta_err``'s tolerance. This probe steps that twin, warm-started
from the same card fit, through the stages of ``models/hashed_linear.
_step_core`` on both devices (256-row chunks of the phase's rows under the
inverted label rule, as the trainer's joined chunks) and names the first
step and the first tensor whose bits part: the hashed indices, the logits
(the dense block's product, then the table rows' sum), ``dl``, the
coefficients' gradient, the table, its adagrad slots, the coefficients. One
JSON line; the card only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stages(theta, opt, X, y, salts, p, lr, reg):
    """One sparse_adagrad 'sort' step, stage by stage (``_step_core``'s
    order): (named intermediates, new theta, new opt)."""
    import numpy as np
    import torch

    from orange3_spark_tpu_torch.models._linear import EPS_TOTAL_WEIGHT, per_row_loss_and_grad
    from orange3_spark_tpu_torch.models.hashed_linear import (
        _hashed_logits, _row_loss_kind, _split_chunk,
    )
    from orange3_spark_tpu_torch.ops.hashing import hash_columns
    from orange3_spark_tpu_torch.optim.sparse import dense_update, sparse_embedding_update

    n = X.shape[0]
    w = torch.ones(n, dtype=torch.float32, device=X.device)
    yv, dense, cats, wv, _ = _split_chunk(X, n, y, w, label_in_chunk=False, n_dense=p.n_dense,
                                          impute_missing=True)
    idx = hash_columns(cats, salts, p.n_dims)
    dense_term = dense @ theta["coef"]
    logits = _hashed_logits(theta, dense, idx)
    sw = torch.clamp_min(wv.sum(), EPS_TOTAL_WEIGHT)
    _, dl = per_row_loss_and_grad(_row_loss_kind(p), logits, yv, wv / sw)
    g_coef, g_int = dense.T @ dl, dl.sum(dim=0)
    decay = float(np.float32(1.0) - np.float32(lr) * np.float32(reg))
    emb, t, eslots = sparse_embedding_update(
        "adagrad", theta["emb"].clone(), opt["t"].clone(),
        {k: v.clone() for k, v in opt["slots"]["emb"].items()}, dl, idx, lr, decay, reg, 0.0,
        opt["step"], lowering="sort", use_decay=reg != 0.0, n_valid=n)
    slots = opt["slots"]
    coef, cslots = dense_update("adagrad", theta["coef"], slots["coef"], g_coef, lr, decay, reg,
                                0.0, use_decay=reg != 0.0)
    icpt, islots = dense_update("adagrad", theta["intercept"], slots["intercept"], g_int, lr,
                                decay, reg, 0.0, use_decay=False)
    named = {"idx": idx, "dense_term": dense_term, "logits": logits, "dl": dl,
             "g_coef": g_coef, "g_int": g_int, "emb": emb, "emb_acc": eslots["acc"],
             "coef": coef, "intercept": icpt}
    theta = {"emb": emb, "coef": coef, "intercept": icpt}
    opt = {"step": opt["step"] + 1, "t": t,
           "slots": {"emb": eslots, "coef": cslots, "intercept": islots}}
    return named, theta, opt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("adagrad_twin_bits: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from orange3_spark_tpu_torch import TorchSession
    from orange3_spark_tpu_torch.io.streaming import array_chunk_source
    from orange3_spark_tpu_torch.models.hashed_linear import StreamingHashedLinearEstimator
    from orange3_spark_tpu_torch.ops.hashing import salts_tensor
    from orange3_spark_tpu_torch.optim.sparse import init_optim_state

    cfg = cs.ONLINE
    rng = np.random.default_rng(cfg["seed"])
    X = np.concatenate([rng.standard_normal((cfg["rows"], 4)).astype(np.float32),
                        rng.integers(0, 500, (cfg["rows"], 4)).astype(np.float32)], axis=1)
    y0 = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    card = TorchSession("cuda")
    model = StreamingHashedLinearEstimator(
        n_dims=cfg["n_dims"], n_dense=4, n_cat=4, epochs=1, step_size=0.05,
        chunk_rows=cfg["chunk_rows"], optim_update="sparse_adagrad").fit_stream(
        array_chunk_source(X, y0, chunk_rows=cfg["chunk_rows"]), session=card)
    p = model.params
    lr, reg = float(np.float32(p.step_size)), float(np.float32(p.reg_param))
    state = {}
    for dev in ("cuda", "cpu"):
        theta = {k: v.detach().to(dev, copy=True) for k, v in model.theta.items()}
        state[dev] = (theta, init_optim_state("sparse_adagrad", theta),
                      salts_tensor(np.asarray(model.salts), torch.device(dev)))
    first, per_step = None, []
    rows = cfg["trainer"]["chunk_rows"]
    for s in range(args.steps):
        i = (s * rows) % (cfg["rows"] - rows)
        named = {}
        for dev in ("cuda", "cpu"):
            theta, opt, salts = state[dev]
            Xd = torch.from_numpy(X[i:i + rows]).to(dev)
            yd = torch.from_numpy(1.0 - y0[i:i + rows]).to(dev)
            named[dev], theta, opt = _stages(theta, opt, Xd, yd, salts, p, lr, reg)
            state[dev] = (theta, opt, salts)
        diffs = {}
        for k, a in named["cuda"].items():
            a, b = a.cpu(), named["cpu"][k]
            differ = int((a != b).sum())
            diffs[k] = {"differ": differ, "max_abs": float((a.double() - b.double()).abs().max())
                        if differ else 0.0}
            if differ and first is None:
                first = {"step": s, "tensor": k, **diffs[k]}
        per_step.append({"step": s, **{k: v["max_abs"] for k, v in diffs.items()
                                      if k in ("logits", "dl", "emb", "coef")}})
    print(json.dumps({"probe": "adagrad_twin_bits", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(), "steps": args.steps,
                      "chunk_rows": rows, "first_parting": first, "per_step_max_abs": per_step}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
