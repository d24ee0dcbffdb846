"""Rank bodies of the MoCo and slow/fast data-parallel tests
(tests/test_torch_moco.py, tests/test_torch_slowfast.py), run by
``facl_tpu_torch.parallel.spawn`` in fresh processes. Torch and the port
only (no JAX), so a rank starts in seconds; the tests compute the JAX side
in their own process. Every body returns CPU tensors and plain
containers."""

from facl_tpu_torch.parallel import COLLECTIVES, batch_slice, make_mesh, \
    shard_train_state


def _zero_counts():
    for c in COLLECTIVES:
        c.calls = 0


def _counts():
    return {c.__name__: c.calls for c in COLLECTIVES if c.calls}


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def moco_step_body(cases, views, steps):
    """For each case (label, Config, query state_dict, key state_dict,
    queue, pointer): the port's MoCoTrainer on this rank's block of
    ``views`` (steps, 2, B, N, C), one step a batch: the first step's
    loss, gradients before Adam, collectives, parameters and buffers after
    it, and the queue and pointer after it; the losses, parameters and
    queue after ``steps`` steps."""
    from facl_tpu_torch.train import MoCoTrainer, shard_moco_state
    mesh = make_mesh()
    local = views[:, :, batch_slice(mesh, views.shape[2])]
    out = {}
    for label, cfg, sd, key_sd, queue, ptr in cases:
        tr = MoCoTrainer(cfg, steps_per_epoch=10, queue_len=queue.shape[0],
                         device="cpu", mesh=mesh)
        st = tr.init_state(0, views.shape[2])
        st.model.load_state_dict(sd)
        st.moco.key_encoder.load_state_dict(key_sd)
        st.moco.queue, st.moco.queue_ptr = queue.clone(), ptr
        st = shard_moco_state(mesh, st)
        _zero_counts()
        st, m = tr.step_fn(st, local[0])
        res = dict(loss=float(m["loss"]), counts=_counts(),
                   grads=_grads(st.model),
                   params={n: p.detach().clone() for n, p in
                           st.model.named_parameters()},
                   buffers={n: b.clone() for n, b in
                            st.model.named_buffers()},
                   queue=st.moco.queue.clone(), ptr=st.moco.queue_ptr)
        losses = [res["loss"]]
        for i in range(1, steps):
            st, m = tr.step_fn(st, local[i])
            losses.append(float(m["loss"]))
        res.update(losses=losses, queue_end=st.moco.queue.clone(),
                   params_end={n: p.detach().clone() for n, p in
                               st.model.named_parameters()})
        out[label] = res
    return out


def slowfast_step_body(cases, points, steps):
    """For each case (label, Config, state_dict): the port's
    SlowFastTrainer on this rank's block of every crop batch of
    ``points`` (steps, G, B, N, C), flattened to G*B/dp clouds as the
    pretrain CLI does: the first step's loss, gradients before Adam,
    collectives, parameters and buffers after it; the losses and
    parameters after ``steps`` steps."""
    from facl_tpu_torch.train import SlowFastTrainer
    mesh = make_mesh()
    local = points[:, :, batch_slice(mesh, points.shape[2])]
    S, G, Bl, N, C = local.shape
    local = local.reshape(S, G * Bl, N, C)
    out = {}
    for label, cfg, sd in cases:
        tr = SlowFastTrainer(cfg, steps_per_epoch=10, slow_k=16, fast_k=8,
                             device="cpu", mesh=mesh)
        st = tr.init_state(0)
        st.model.load_state_dict(sd)
        st = shard_train_state(mesh, st)
        _zero_counts()
        st, m = tr.step_fn(st, local[0])
        res = dict(loss=float(m["loss"]), counts=_counts(),
                   grads=_grads(st.model),
                   params={n: p.detach().clone() for n, p in
                           st.model.named_parameters()},
                   buffers={n: b.clone() for n, b in
                            st.model.named_buffers()})
        losses = [res["loss"]]
        for i in range(1, steps):
            st, m = tr.step_fn(st, local[i])
            losses.append(float(m["loss"]))
        res.update(losses=losses, params_end={
            n: p.detach().clone() for n, p in st.model.named_parameters()})
        out[label] = res
    return out


def cli_body(calls):
    """Each (CLI module of facl_tpu_torch.cli, argv) of ``calls`` through
    its main() (under ``--mesh`` where the argv asks): what it returns, or
    the message of the SystemExit it raises; the collectives of all of
    them; this rank."""
    import importlib
    _zero_counts()
    out = []
    for name, argv in calls:
        cli = importlib.import_module(f"facl_tpu_torch.cli.{name}")
        try:
            out.append(cli.main(list(argv)))
        except SystemExit as e:
            out.append(str(e))
    return dict(results=out, counts=_counts(), rank=make_mesh().rank)
