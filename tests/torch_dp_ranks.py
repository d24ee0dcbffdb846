"""Rank bodies of the port's data- and tensor-parallel tests (tests/
test_torch_parallel.py, test_torch_sharded_pair.py, test_torch_dp_step.py,
test_torch_dp_cli.py, test_torch_mp_step.py), run by ``facl_tpu_torch.parallel.spawn`` in fresh
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


# -- tests/test_torch_mp_step.py ---------------------------------------

def mp_counts():
    from facl_tpu_torch.parallel import MP_COLLECTIVES
    out = counts()
    out.update({c.__name__: c.calls for c in MP_COLLECTIVES})
    return out


def zero_mp_counts():
    from facl_tpu_torch.parallel import MP_COLLECTIVES
    zero_counts()
    for c in MP_COLLECTIVES:
        c.calls = 0


def _full_grads(model):
    """Every gradient whole: a split weight's block gathered over the mp
    ranks."""
    from facl_tpu_torch.models.layers import column_blocks
    from facl_tpu_torch.parallel import mp_full
    blocks = column_blocks(model)
    return {n: (mp_full(p.grad, blocks[id(p)].mesh) if id(p) in blocks
                else p.grad.clone())
            for n, p in model.named_parameters() if p.grad is not None}


def _state_bytes(st):
    """Bytes of this rank's parameters plus Adam's state tensors."""
    n = sum(p.numel() * p.element_size() for p in st.model.parameters())
    for per in st.optimizer.state.values():
        n += sum(t.numel() * t.element_size() for t in per.values()
                 if isinstance(t, torch.Tensor))
    return n


def _sharded_names(st):
    """(parameters held as a column block, parameters whose Adam moments
    are blocks) by name."""
    from facl_tpu_torch.models.layers import column_blocks
    blocks = column_blocks(st.model, st.optimizer)
    params = [n for n, p in st.model.named_parameters() if id(p) in blocks]
    moments = [n for n, p in st.model.named_parameters()
               if any(id(t) in blocks for t in
                      st.optimizer.state.get(p, {}).values())]
    return params, moments


def _full_state(st):
    from facl_tpu_torch.models.layers import full_optimizer_state_dict, \
        full_state_dict
    opt = full_optimizer_state_dict(st.optimizer, st.model)
    opt["state"] = {i: {k: v.clone() for k, v in per.items()}
                    for i, per in opt["state"].items()}
    return dict(model={n: t.clone() for n, t in
                       full_state_dict(st.model).items()}, optimizer=opt)


def mp_step_body(mesh_shape, cases, points, perm, steps, ckpt=None):
    """For each case (label, Config, state_dict) on the mesh ``mesh_shape``
    (dp, mp): the port's Trainer on this rank's dp block of ``points``
    (G, B, N, C), from ``state_dict`` (whole; each rank keeps its
    blocks), with circle permutation ``perm``: the first step's loss,
    gradients before Adam (whole), BatchNorm buffers, collectives and
    the split names, the whole parameters after it and after ``steps``
    steps, this rank's blocks, and the bytes of parameters plus Adam
    state. With ``ckpt`` (a directory), the first case also writes a
    checkpoint at init and one after its steps, reads the second back
    into a fresh state on the mesh, and returns the whole state it wrote
    and the blocks it restored."""
    from facl_tpu_torch.config import MeshConfig
    from facl_tpu_torch.parallel import shard_train_state
    from facl_tpu_torch.train import Trainer, restore_checkpoint, \
        save_checkpoint
    mesh = make_mesh(MeshConfig(*mesh_shape))
    local = points[:, batch_slice(mesh, points.shape[1])]
    out = {"at": (mesh.rank, mesh.mp_rank)}
    for k, (label, cfg, sd) in enumerate(cases):
        tr = Trainer(cfg, steps_per_epoch=10, device="cpu", mesh=mesh)
        st = tr.init_state(0)
        st.model.load_state_dict(sd)
        st = shard_train_state(mesh, st)
        res = {}
        if ckpt is not None and k == 0:
            res["ckpt_init"] = save_checkpoint(f"{ckpt}/init", st, 0,
                                               mesh=mesh)
        zero_mp_counts()
        st, m = tr.step_fn(st, local, perm=perm)
        res.update(loss=float(m["loss"]), counts=mp_counts(),
                   buffers={n: b.clone() for n, b in
                            st.model.named_buffers()},
                   bytes=_state_bytes(st), sharded=_sharded_names(st))
        res["grads"] = _full_grads(st.model)
        res["params"] = _full_state(st)["model"]
        for _ in range(steps - 1):
            st, _ = tr.step_fn(st, local, perm=perm)
        res["params_end"] = _full_state(st)["model"]
        res["blocks_end"] = {n: p.detach().clone() for n, p in
                             st.model.named_parameters()}
        if ckpt is not None and k == 0:
            res["written"] = _full_state(st)
            res["ckpt"] = save_checkpoint(f"{ckpt}/step", st, 1, mesh=mesh)
            st2 = tr.init_state(5)
            restore_checkpoint(res["ckpt"], st2)
            res["restored"] = dict(
                params={n: p.detach().clone() for n, p in
                        st2.model.named_parameters()},
                moments={n: {k2: v.clone() for k2, v in
                             st2.optimizer.state[p].items()}
                         for n, p in st2.model.named_parameters()
                         if p in st2.optimizer.state})
        out[label] = res
    return out


def mp_moco_slowfast_body(mesh_shape, moco, slowfast):
    """MoCo and slow/fast on the mesh ``mesh_shape`` (dp, mp), each from
    whole weights: ``moco`` (Config, query state_dict, queue, views (2, B,
    N, C)) and ``slowfast`` (Config, state_dict, clouds (B, N, C)). For
    each, two steps on this rank's dp block: the first step's loss,
    gradients before Adam (whole), collectives; for MoCo also the key
    encoder and the queue after each step."""
    from facl_tpu_torch.config import MeshConfig
    from facl_tpu_torch.parallel import shard_train_state
    from facl_tpu_torch.train import MoCoTrainer, SlowFastTrainer, \
        shard_moco_state
    mesh = make_mesh(MeshConfig(*mesh_shape))
    out = {}
    cfg, sd, queue, views = moco
    tr = MoCoTrainer(cfg, steps_per_epoch=10, queue_len=queue.shape[0],
                     device="cpu", mesh=mesh)
    st = tr.init_state(0, views.shape[1])
    st.model.load_state_dict(sd)
    st.moco.key_encoder.load_state_dict(sd)
    st.moco.queue = queue.clone()
    st = shard_moco_state(mesh, st)
    local = views[:, batch_slice(mesh, views.shape[1])]
    res = {"losses": [], "keys": [], "queues": []}
    for i in range(2):
        zero_mp_counts()
        st, m = tr.step_fn(st, local)
        res["losses"].append(float(m["loss"]))
        if i == 0:
            res.update(counts=mp_counts(), grads=_full_grads(st.model))
        res["keys"].append({n: t.clone() for n, t in
                            st.moco.key_encoder.state_dict().items()})
        res["queues"].append(st.moco.queue.clone())
    out["moco"] = res
    cfg, sd, clouds = slowfast
    tr = SlowFastTrainer(cfg, steps_per_epoch=10, slow_k=16, fast_k=8,
                         device="cpu", mesh=mesh)
    st = tr.init_state(0)
    st.model.load_state_dict(sd)
    st = shard_train_state(mesh, st)
    local = clouds[batch_slice(mesh, clouds.shape[0])]
    res = {"losses": []}
    for i in range(2):
        zero_mp_counts()
        st, m = tr.step_fn(st, local)
        res["losses"].append(float(m["loss"]))
        if i == 0:
            res.update(counts=mp_counts(), grads=_full_grads(st.model),
                       sharded=_sharded_names(st)[0])
    res["params_end"] = _full_state(st)["model"]
    out["slow_fast"] = res
    return out


def mp_collectives_body(mesh_shape, x, w):
    """The mesh's layout and groups, and each mp collective on float64
    data: a column-parallel GEMM ``mp_gather_cols(mp_enter(x) @ W_m)``
    with this rank's column block of ``w``, its loss sum(y * y) and the
    gradients of x and of the block; ``mp_full`` of the block; the dp
    collectives' view of the mesh (``batch_slice``)."""
    import torch.distributed as dist
    from facl_tpu_torch.config import MeshConfig
    from facl_tpu_torch.parallel import mp_enter, mp_full, mp_gather_cols
    mesh = make_mesh(MeshConfig(*mesh_shape))
    zero_mp_counts()
    c = w.shape[1] // mesh.mp
    wb = w[:, mesh.mp_rank * c:(mesh.mp_rank + 1) * c].clone() \
        .requires_grad_()
    xr = x.clone().requires_grad_()
    y = mp_gather_cols(mp_enter(xr, mesh) @ wb, mesh)
    (y * y).sum().backward()
    members = [dist.get_process_group_ranks(g) if g is not None else None
               for g in (mesh.group, mesh.mp_group)]
    return dict(at=(mesh.rank, mesh.mp_rank), shape=mesh.shape,
                global_rank=mesh.global_rank, lead=mesh.lead,
                members=members, y=y.detach(), dx=xr.grad, dw=wb.grad,
                full=mp_full(wb.detach().T.contiguous(), mesh),
                slice=batch_slice(mesh, 8), counts=mp_counts())
