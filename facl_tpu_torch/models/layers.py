"""Shared building blocks for the point encoders (counterpart of
facl_tpu/models/layers.py).

BatchNorm follows flax's convention, not ``torch.nn.BatchNorm1d``'s:
statistics over every non-channel axis of a channels-last input, the
biased variance (E[x^2] - E[x]^2 clamped at 0) both for normalising and
for the running update ``m*old + (1-m)*new`` with m = 0.9. Parameter and
buffer names follow flax's (``scale``/``bias``, ``mean``/``var``) so that
``facl_tpu_torch.convert.from_jax`` maps variable trees one to one.

``dtype`` is the compute dtype, as flax's ``dtype=`` (facl_tpu/models/
layers.py): at ``torch.bfloat16`` a Dense multiplies in bf16 from its f32
parameters (f32 accumulation) and adds its bf16 bias to the bf16 product;
a BatchNorm takes its statistics over the f32 upcast, updates its running
buffers in f32, normalises in f32 and casts its output to bf16
(flax/linen/normalization.py ``_compute_stats`` / ``_normalize``).
Parameters and buffers stay f32.

Tensor parallelism (a ``mesh`` with ``mp > 1``, parallel/mesh.py): a
Dense whose kernel JAX's rule splits (``mp_sharded``: 512 output columns
or more) is a :class:`ColumnDense`, which holds this rank's block of the
output columns and a replicated bias, and gathers the full output after
its GEMM. Everything after the gather (BatchNorm, ReLU, the pools, the
head's next layers) is replicated over the mp ranks.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from facl_tpu_torch.parallel.collectives import global_moments, \
    mp_enter, mp_full, mp_gather_cols
from facl_tpu_torch.parallel.mesh import mp_sharded


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default Dense init: truncated normal (+-2 std) with variance
    1/fan_in after truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)


class ColumnDense(nn.Module):
    """A Dense split over the mesh's mp ranks by output columns (JAX's
    ``P(None, 'mp')`` on the (in, out) kernel): ``weight`` is this rank's
    rows ``[m * out / mp, (m + 1) * out / mp)`` of the ``nn.Linear``
    weight (out, in), ``bias`` the full (out,) bias. The forward is
    ``mp_gather_cols(F.linear(mp_enter(x), weight))`` plus the bias, so
    its output and everything after it are replicated over the mp ranks.
    The initial kernel is drawn whole from the generator, as
    :func:`dense` draws it, and cut to the block, so a seed gives the
    one-process weights. ``load_state_dict`` takes the full weight (a
    checkpoint, ``convert.from_jax``) and keeps the block."""

    def __init__(self, cin: int, cout: int, mesh, bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cout % mesh.mp:
            raise ValueError(f"a Dense of {cout} columns does not split "
                             f"over mp={mesh.mp} ranks")
        self.in_features, self.out_features, self.mesh = cin, cout, mesh
        w = torch.empty(cin, cout)
        lecun_normal_(w, cin, generator)
        self.weight = nn.Parameter(self.block(w.T).clone())
        self.register_parameter(
            "bias", nn.Parameter(torch.zeros(cout)) if bias else None)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a tensor of the full weight's shape."""
        c = self.out_features // self.mesh.mp
        return full[self.mesh.mp_rank * c:(self.mesh.mp_rank + 1) * c]

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        w = state_dict.get(prefix + "weight")
        if w is not None and tuple(w.shape) == (self.out_features,
                                                self.in_features):
            state_dict = dict(state_dict)          # the caller's stays whole
            state_dict[prefix + "weight"] = self.block(w)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        bf = dtype == torch.bfloat16
        w = self.weight.to(dtype) if bf else self.weight
        y = nn.functional.linear(mp_enter(x.to(dtype) if bf else x,
                                          self.mesh), w)
        y = mp_gather_cols(y, self.mesh)
        if self.bias is None:
            return y
        return y + (self.bias.to(dtype) if bf else self.bias)


def dense(cin: int, cout: int, bias: bool = True,
          generator: Optional[torch.Generator] = None, mesh=None):
    """nn.Linear initialised like flax's nn.Dense (lecun-normal kernel,
    zero bias); a :class:`ColumnDense` where the ``mesh``'s mp rule
    splits the (cin, cout) kernel."""
    if mp_sharded(mesh, (cin, cout)):
        return ColumnDense(cin, cout, mesh, bias, generator)
    lin = nn.Linear(cin, cout, bias=bias)
    w = torch.empty(cin, cout)
    lecun_normal_(w, cin, generator)
    with torch.no_grad():
        lin.weight.copy_(w.T)
        if bias:
            lin.bias.zero_()
    return lin


def kernel_of(lin) -> torch.Tensor:
    """The full (in, out) kernel of a Dense, differentiable (a
    ColumnDense's blocks gathered)."""
    if isinstance(lin, ColumnDense):
        return mp_gather_cols(lin.weight.T, lin.mesh)
    return lin.weight.T


def apply_dense(lin, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``lin(x)``; at bf16 as flax's ``nn.Dense(dtype=bfloat16)``: the
    product of the bf16 input and kernel (rounded once), plus the bf16
    bias. A ColumnDense runs its column block (its forward)."""
    if isinstance(lin, ColumnDense):
        return lin(x, dtype)
    if dtype != torch.bfloat16:
        return lin(x)
    y = nn.functional.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the trailing channel axis, flax semantics. With a
    data-parallel ``mesh`` (parallel/mesh.py) the training statistics are
    over every rank's rows, as JAX's on a dp mesh (SyncBN semantics)."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 mesh=None):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.mesh = mesh
        self.scale = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("mean", torch.zeros(num_features))
        self.register_buffer("var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf = self.dtype == torch.bfloat16
        if bf:
            x = x.float()
        if self.training:
            mean, var = global_moments(x.reshape(-1, x.shape[-1]), self.mesh)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) \
            + self.bias
        return y.to(self.dtype) if bf else y


class PointMLP(nn.Module):
    """Stack of [Dense -> BatchNorm -> ReLU] over the trailing channel axis
    (the 1x1-conv shared MLP)."""

    def __init__(self, in_features: int, widths: Sequence[int],
                 bn_momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.n, self.dtype = len(widths), dtype
        cin = in_features
        for i, w in enumerate(widths):
            setattr(self, f"dense_{i}", dense(cin, w, generator=generator,
                                              mesh=mesh))
            setattr(self, f"BatchNorm_{i}",
                    BatchNorm(w, bn_momentum, dtype=dtype, mesh=mesh))
            cin = w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = apply_dense(getattr(self, f"dense_{i}"), x, self.dtype)
            x = torch.relu(getattr(self, f"BatchNorm_{i}")(x))
        return x


class EmbedHead(nn.Module):
    """The reference's ``netR_FC``: Linear -> BN -> ReLU -> Linear
    (cn3d_model_conbag.py:82-88), shared by the local and global paths."""

    def __init__(self, in_features: int, hidden: int = 1024, out: int = 512,
                 bn_momentum: float = 0.9,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = torch.float32, mesh=None):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = dense(in_features, hidden, generator=generator,
                             mesh=mesh)
        self.BatchNorm_0 = BatchNorm(hidden, bn_momentum, dtype=dtype,
                                     mesh=mesh)
        self.Dense_1 = dense(hidden, out, generator=generator, mesh=mesh)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.BatchNorm_0(apply_dense(self.Dense_0, x,
                                                    self.dtype)))
        return apply_dense(self.Dense_1, h, self.dtype)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize(p=2) semantics (clamped norm)."""
    return x / torch.linalg.vector_norm(x, dim=dim,
                                        keepdim=True).clamp_min(eps)


# -- split kernels: their full tensors and blocks -------------------------

def column_blocks(model: nn.Module, optimizer=None) -> dict:
    """{id(tensor): its ColumnDense} for every split weight of ``model``
    and every Adam moment of one (the tensors of a weight's block shape
    in ``optimizer``'s state)."""
    out = {}
    for mod in model.modules():
        if isinstance(mod, ColumnDense):
            out[id(mod.weight)] = mod
            st = optimizer.state.get(mod.weight, {}) if optimizer else {}
            out.update((id(t), mod) for t in st.values()
                       if isinstance(t, torch.Tensor) and
                       t.shape == mod.weight.shape)
    return out


def full_state_dict(model: nn.Module) -> dict:
    """``model.state_dict()`` with every split weight whole (gathered over
    the mp ranks: every rank calls it): the one-process state dict."""
    sd = model.state_dict()
    for name, mod in model.named_modules():
        if isinstance(mod, ColumnDense):
            key = f"{name}.weight" if name else "weight"
            sd[key] = mp_full(mod.weight, mod.mesh)
    return sd


def full_parameters(model: nn.Module) -> list:
    """``model.parameters()`` with every split weight whole (gathered, no
    gradient; every rank calls it)."""
    blocks = column_blocks(model)
    return [mp_full(p, blocks[id(p)].mesh) if id(p) in blocks else p
            for p in model.parameters()]


def full_optimizer_state_dict(optimizer, model: nn.Module) -> dict:
    """``optimizer.state_dict()`` with the moments of every split weight
    whole (gathered; every rank calls it); the optimizer's own state is
    left as it is."""
    sd = optimizer.state_dict()
    blocks = column_blocks(model, optimizer)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for i, p in enumerate(params):
        if id(p) in blocks and i in sd["state"]:
            mesh = blocks[id(p)].mesh
            sd["state"][i] = {k: mp_full(v, mesh) if id(v) in blocks else v
                              for k, v in sd["state"][i].items()}
    return sd


def shard_optimizer_state(optimizer, model: nn.Module) -> None:
    """After ``optimizer.load_state_dict`` of a whole state: keep this
    rank's block of each split weight's moments, in place."""
    for mod in model.modules():
        if not isinstance(mod, ColumnDense):
            continue
        st = optimizer.state.get(mod.weight, {})
        for k, v in st.items():
            if isinstance(v, torch.Tensor) and \
                    tuple(v.shape) == (mod.out_features, mod.in_features):
                st[k] = mod.block(v).clone()
