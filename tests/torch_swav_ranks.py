"""Rank body of tests/test_torch_swav_cld.py's data-parallel case, run by
``facl_tpu_torch.parallel.spawn``. Torch and the port only (no JAX), so a
rank starts in seconds."""
import torch

from facl_tpu_torch.parallel import batch_slice, make_mesh, \
    shard_train_state


def swav_step_body(cfg, sd, queue, points, perm, epoch):
    """One SwAV+CLD step of the port's Trainer on this rank's block of
    ``points`` (G, B, N, C), from ``state_dict`` ``sd`` and ``queue``:
    the loss terms, the gradients before Adam and the new queue."""
    from facl_tpu_torch.train import Trainer
    mesh = make_mesh()
    tr = Trainer(cfg, steps_per_epoch=10, device="cpu", mesh=mesh)
    st = tr.init_state(0)
    st.model.load_state_dict(sd)
    st.swav_queue = queue.clone()
    st = shard_train_state(mesh, st)
    local = points[:, batch_slice(mesh, points.shape[1])]
    st, m = tr.step_fn(st, local, perm=perm, epoch=epoch)
    return dict(metrics={k: float(v) for k, v in m.items()},
                grads={n: p.grad.clone() for n, p in
                       st.model.named_parameters() if p.grad is not None},
                queue=st.swav_queue.clone())
