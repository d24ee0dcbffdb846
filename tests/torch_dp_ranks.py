"""Rank bodies of the port's data-parallel tests (tests/test_torch_
parallel.py, test_torch_sharded_pair.py, test_torch_dp_step.py,
test_torch_dp_cli.py), run by ``facl_tpu_torch.parallel.spawn`` in fresh
processes. This module imports torch and the port only (no JAX), so a rank
starts in seconds; the tests compute the JAX side in their own process.
Every body returns CPU tensors and plain containers."""
import time

import torch

from facl_tpu_torch.parallel import COLLECTIVES, all_gather, barrier, \
    batch_slice, broadcast, cross_replica_mean, gather_negatives, \
    global_moments, make_mesh, psum, psum_grads, psum_packed


def counts():
    return {c.__name__: c.calls for c in COLLECTIVES}


def zero_counts():
    for c in COLLECTIVES:
        c.calls = 0


# -- tests/test_torch_parallel.py --------------------------------------

def collectives_body(xs, w):
    """Each collective on this rank's block of float64 data ``xs`` (R, C)
    rows of every rank, in rank order) and its gradient through a loss
    that sums w * (the rank's normalised rows)."""
    mesh = make_mesh()
    r, dp = mesh.rank, mesh.dp
    zero_counts()
    x = xs[batch_slice(mesh, xs.shape[0])].clone().requires_grad_()
    out = {"rank": r, "dp": dp}
    out["psum"] = psum(torch.full((3,), float(r + 1), dtype=torch.float64),
                       mesh)
    a, b = psum_packed([torch.full((2, 2), float(r), dtype=torch.float32),
                        torch.full((3,), 1.0, dtype=torch.float64)], mesh)
    out["packed"] = (a, b)
    g = gather_negatives(x, mesh)
    out["gathered"] = g.detach()
    (g * w[: g.shape[0]]).sum().backward()
    out["gather_grad"] = x.grad.clone()
    x.grad = None
    mean, var = global_moments(x, mesh)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    (y * w[batch_slice(mesh, xs.shape[0])]).sum().backward()
    out["moments"] = (mean.detach(), var.detach())
    out["moments_grad"] = x.grad.clone()
    out["all_gather"] = all_gather(x.detach() * 2, mesh)
    p = torch.nn.Parameter(torch.zeros(2))
    p.grad = torch.full((2,), float(r + 1))
    q = torch.nn.Parameter(torch.zeros(1))          # no gradient: left out
    psum_grads([p, q], mesh)
    out["psum_grads"] = p.grad.clone()
    out["broadcast"] = broadcast(torch.full((2,), float(r + 7)), mesh)
    barrier(mesh)
    out["mean_over_ranks"] = cross_replica_mean(torch.tensor([float(r)]),
                                                mesh)
    out["counts"] = counts()
    return out


def fail_on_rank_1():
    if make_mesh().rank == 1:
        raise ValueError("rank 1 failed on purpose")
    return "ok"


def hang_in_collective():
    """Rank 0 waits in an all_reduce that rank 1 never joins."""
    mesh = make_mesh()
    if mesh.rank == 1:
        time.sleep(3600)
    return psum(torch.ones(1), mesh)


# -- tests/test_torch_sharded_pair.py ----------------------------------

def sharded_pair_body(x_cf, layers, wvec, cases):
    """For each case (slim, dtype): the pair stage (pair3 with slim, else
    pair) on this rank's block of x_cf: the loss sum(sin(pooled) * wvec)
    over the rank's rows, the statistics, the parameter gradients and the
    B6s all-reduces (psum calls) of the forward and of the backward."""
    from facl_tpu_torch.ops.fused_sa import SALayerParams
    from facl_tpu_torch.ops.sa_pair import sa_train_pair
    mesh = make_mesh()
    xr = x_cf[batch_slice(mesh, x_cf.shape[0])]
    out = {}
    for slim, dtype in cases:
        ps = [SALayerParams(*(torch.tensor(a).requires_grad_() for a in lp))
              for lp in layers]
        zero_counts()
        pooled, stats = sa_train_pair(xr, ps, 1e-5, slim=slim, dtype=dtype,
                                      mesh=mesh)
        fwd = psum.calls
        loss = (torch.sin(pooled.float()) * wvec).sum()
        loss.backward()
        out[slim, dtype] = dict(
            loss=loss.detach(), pooled=pooled.detach(),
            stats=[(m.detach(), v.detach()) for m, v in stats],
            grads=[[t.grad.clone() for t in lp] for lp in ps],
            psum_fwd=fwd, psum_bwd=psum.calls - fwd, counts=counts())
    try:
        sa_train_pair(xr[:1], [SALayerParams(*map(torch.tensor, lp))
                               for lp in layers], 1e-5, slim=True,
                      mesh=mesh)
        out["odd_rows"] = None
    except ValueError as e:
        out["odd_rows"] = str(e)
    return out


# -- tests/test_torch_dp_step.py ---------------------------------------

def dp_step_body(cases, points, perm, steps):
    """For each case (label, Config, state_dict): the port's Trainer on
    this rank's block of ``points`` (G, B, N, C), from ``state_dict``, with
    circle permutation ``perm``: the first step's loss, gradients before
    Adam, BatchNorm buffers and parameters after it, the collectives run
    in it, and the parameters after ``steps`` steps."""
    from facl_tpu_torch.parallel import shard_train_state
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    local = points[:, batch_slice(mesh, points.shape[1])]
    out = {}
    for label, cfg, sd in cases:
        tr = Trainer(cfg, steps_per_epoch=10, device="cpu", mesh=mesh)
        st = tr.init_state(0)
        st.model.load_state_dict(sd)
        st = shard_train_state(mesh, st)
        zero_counts()
        st, m = tr.step_fn(st, local, perm=perm)
        res = dict(loss=float(m["loss"]), counts=counts(),
                   grads={n: p.grad.clone() for n, p in
                          st.model.named_parameters() if p.grad is not None},
                   params={n: p.detach().clone() for n, p in
                           st.model.named_parameters()},
                   buffers={n: b.clone() for n, b in
                            st.model.named_buffers()})
        for _ in range(steps - 1):
            st, _ = tr.step_fn(st, local, perm=perm)
        res["params_end"] = {n: p.detach().clone() for n, p in
                             st.model.named_parameters()}
        out[label] = res
    return out


def dp_rejects_body(cfgs):
    """(impl, exception class name and message) of building each config's
    Trainer state under this mesh."""
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    out = []
    for label, cfg in cfgs:
        try:
            Trainer(cfg, 10, device="cpu", mesh=mesh).init_state(0)
            out.append((label, None, ""))
        except (NotImplementedError, ValueError) as e:
            out.append((label, type(e).__name__, str(e)))
    return out


# -- tests/test_torch_dp_cli.py ----------------------------------------

def cli_body(pretrain_args, resume_args, extract_args):
    """pretrain --mesh (one epoch), again with --resume, then extract
    --mesh, each through its main(); returns what they return and the
    collectives they ran."""
    from facl_tpu_torch.cli import extract, pretrain
    zero_counts()
    hist = pretrain.main(list(pretrain_args))
    hist2 = pretrain.main(list(resume_args))
    n = extract.main(list(extract_args))
    return dict(hist=hist, hist2=hist2, written=n, rank=make_mesh().rank,
                counts=counts())
