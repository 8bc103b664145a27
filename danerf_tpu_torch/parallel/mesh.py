"""Data and tensor parallelism on ``torch.distributed`` (counterpart of
danerf_tpu/parallel/mesh.py).

The layout is the JAX package's ``(data, model)`` mesh, laid over the ranks
of the process group: rank r sits at ``(r // model, r % model)``, as
``devices.reshape(data, model)`` places device r.

- ``data``: rays sharded.  Every rank draws the *global* batch and its
  jitter from the same seeded generator (so every rank's generator stays in
  step, the SPMD contract of the JAX module), takes its contiguous block of
  rays (the block ``P('data')`` gives device r), runs the path's loss and
  gradients on it, and one all-reduce over the data group of one flat
  buffer (every gradient, then the step's metrics) averages them; then
  Adam.  What GSPMD inserts in the JAX step is written out here.
- ``model``: Megatron-style tensor parallelism over the trunk's hidden
  features (``param_pspecs``): even trunk layers column-parallel, odd ones
  row-parallel, the heads replicated.  On the module route (``use_kernels``
  off) ``TPNeRF`` computes that way, one all-reduce over the model group a
  row-parallel layer.  The kernels take whole packed weights, so on the
  kernel route the trunk shards are all-gathered before the step and each
  rank keeps its shard's slice of the averaged gradient: storage-sharded,
  not compute-sharded.  As in the JAX package this is capability, not
  speed: pure data parallelism is the layout to train with.

Every gather here is an all-reduce of a zero-filled buffer into which each
rank writes its part: gloo on CUDA tensors has only ``broadcast`` and
``all_reduce``, and NCCL takes both.  A rank's share of work outside the
step (the frames of a camera path) is ``process_slice``.
"""

from __future__ import annotations

import copy
import os
import re
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.models.nerf import NeRF, _linear


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           backend: Optional[str] = None) -> bool:
    """Join the process group (no-op when single-process); returns True when
    a multi-process group was initialized.

    ``coordinator_address`` is ``host:port`` of rank 0 (``tcp://``), or
    ``"auto"``: torchrun's environment (``env://``: ``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``).  On
    ``device`` cuda (the default; raises without CUDA) the rank first takes
    its card, ``LOCAL_RANK`` or else rank % cards, and the backend is NCCL;
    on the CPU it is gloo.  ``backend`` overrides that (gloo on the card:
    several ranks on one card, which NCCL refuses).  On the card the local
    rank 0 then builds the kernels while the others wait at a barrier, so
    that no two ranks compile the same source."""
    if num_processes is not None and num_processes == 1:
        return False
    if coordinator_address is None and num_processes is None and process_id is None:
        return False
    dev = resolve_device(device)
    if coordinator_address == "auto":
        init_method = "env://"
        rank = int(os.environ["RANK"]) if process_id is None else process_id
        world = int(os.environ["WORLD_SIZE"]) if num_processes is None else num_processes
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("coordinator_address, num_processes and process_id are needed "
                             "together (or coordinator_address='auto' under torchrun)")
        init_method, rank, world = f"tcp://{coordinator_address}", process_id, num_processes
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {}
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    if dev.type == "cuda":
        _build_kernels_once(local)
    return True


def _build_kernels_once(local_rank: int) -> None:
    """The local rank 0 builds every stale kernel; the others wait, then
    find them built.  A failed build raises on rank 0 after the barrier."""
    from danerf_tpu_torch.kernels import _build

    err = None
    if local_rank == 0:
        try:
            _build.build()
        except RuntimeError as e:
            err = e
    dist.barrier()
    if err is not None:
        raise err


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _share(n_items: int, index: int, count: int) -> slice:
    """Part ``index`` of ``count`` contiguous parts of ``n_items`` (the
    last ones shorter or empty)."""
    per = -(-n_items // count)
    return slice(min(index * per, n_items), min((index + 1) * per, n_items))


def process_slice(n_items: int) -> slice:
    """This process's contiguous share of ``n_items`` host-side work items
    (the frames of a camera path rendered without a mesh); all of them
    without a process group."""
    return _share(n_items, *_rank_world())


class Mesh:
    """The ``(data, model)`` layout over every rank of the process group:
    rank r at ``(data_index, model_index) = (r // model, r % model)``.
    ``data_group`` holds the ranks of r's model column (the replicas whose
    gradients and rays are combined), ``model_group`` those of r's data row
    (the shards of one tensor-parallel layer).  ``device`` is where the
    tensors its collectives carry lie.  A copy is the same mesh (its process
    groups are handles)."""

    def __init__(self, data: int, model: int, device: torch.device):
        self.data, self.model, self.device = data, model, device
        self.rank = dist.get_rank()
        self.data_index, self.model_index = divmod(self.rank, model)
        # every rank creates every group, in the same order
        for i in range(data):
            group = dist.new_group([i * model + j for j in range(model)])
            if i == self.data_index:
                self.model_group = group
        for j in range(model):
            group = dist.new_group([i * model + j for i in range(data)])
            if j == self.model_index:
                self.data_group = group

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    def __deepcopy__(self, memo):
        return self

    def share(self, n_items: int) -> slice:
        """This rank's contiguous share of ``n_items`` rays along ``data``."""
        return _share(n_items, self.data_index, self.data)

    def sum_data(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the data group."""
        dist.all_reduce(t, group=self.data_group)
        return t


def make_mesh(data: Optional[int] = None, model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over all ranks of the process group
    (``initialize_distributed``, or ``torch.distributed.init_process_group``)
    for tensors on ``device``: the card unless the caller asks for the CPU
    (raises without CUDA).  ``data`` defaults to ranks // model."""
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(initialize_distributed)")
    world = dist.get_world_size()
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    return Mesh(data, model, dev)


# ----------------------------------------------------------------- shardings

_TRUNK = re.compile(r"pts_linears\.(\d+)\.(weight|bias)")


def _split_dim(name: str) -> Optional[int]:
    """The dimension of parameter ``name`` (torch layout, weights (out, in))
    that tensor parallelism splits, or None where it is replicated: a
    column-parallel trunk layer (even index) splits its output features
    (weight rows and bias), a row-parallel one (odd index) its input
    features (weight columns; its bias is replicated)."""
    m = _TRUNK.fullmatch(name)
    if m is None:
        return None
    if int(m.group(1)) % 2 == 0:
        return 0
    return 1 if m.group(2) == "weight" else None


def param_pspecs(model, tensor_parallel: bool) -> dict:
    """{parameter name: spec} of the module, a spec naming per dimension
    (torch layout) the mesh axis that splits it: ``()`` replicated, as JAX's
    ``P()``.  Pure data parallelism replicates everything; with tensor
    parallelism a column-parallel trunk layer's weight is ``("model",
    None)`` and its bias ``("model",)`` (JAX: ``P(None, 'model')``,
    ``P('model')`` on (in, out)), a row-parallel one's weight ``(None,
    "model")`` and its bias ``()`` (JAX: ``P('model', None)``, ``P()``)."""
    specs = {}
    for name, p in model.named_parameters():
        dim = _split_dim(name) if tensor_parallel else None
        specs[name] = () if dim is None else tuple(
            "model" if i == dim else None for i in range(p.dim()))
    return specs


def _shard(t: torch.Tensor, name: str, mesh: Mesh) -> torch.Tensor:
    """Rank's slice of full tensor ``t`` (parameter ``name`` or its Adam
    moment) along the model axis."""
    dim = _split_dim(name)
    if dim is None:
        return t.detach().clone()
    if t.shape[dim] % mesh.model:
        raise ValueError(
            f"{name}: dimension {dim} of shape {tuple(t.shape)} does not split over "
            f"model={mesh.model} (a skip layer at an odd index is row-parallel over "
            f"hidden + encoded inputs; the JAX package's device_put refuses it too)")
    k = t.shape[dim] // mesh.model
    return t.detach().narrow(dim, mesh.model_index * k, k).clone()


def _unshard(t: torch.Tensor, name: str, mesh: Mesh) -> torch.Tensor:
    """The full tensor of shard ``t`` of parameter ``name``, on every rank
    of the model group."""
    dim = _split_dim(name)
    if dim is None:
        return t.detach().clone()
    k = t.shape[dim]
    shape = list(t.shape)
    shape[dim] = k * mesh.model
    full = t.new_zeros(shape)
    full.narrow(dim, mesh.model_index * k, k).copy_(t.detach())
    dist.all_reduce(full, group=mesh.model_group)
    return full


class _ToModelParallel(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group (a replicated input feeding each rank's column slice)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModelParallel(torch.autograd.Function):
    """Sum of the partial products over the model group forward; identity
    backward (the loss after it is replicated over the group)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModelParallel(torch.autograd.Function):
    """The column slices of the model group concatenated forward; the
    rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, mesh):
        k = x.shape[-1]
        ctx.at = (mesh.model_index * k, k)
        full = x.new_zeros(x.shape[:-1] + (k * mesh.model,))
        full.narrow(-1, *ctx.at).copy_(x)
        dist.all_reduce(full, group=mesh.model_group)
        return full

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, *ctx.at).contiguous(), None


class TPNeRF(NeRF):
    """A ``NeRF`` module whose trunk holds this rank's tensor-parallel shards
    (``param_pspecs``): the same parameter names, shard shapes.  Its trunk
    computes the Megatron way: a column-parallel layer its slice of the
    output features from the replicated input; a row-parallel layer a
    partial product over its input slice, summed over the model group before
    its bias and relu; after an odd number of layers the slices are
    gathered for the heads.  A skip layer must be column-parallel (even
    index): its input is the full hidden state beside the encoding."""

    def __init__(self, full: NeRF, mesh: Mesh):
        nn.Module.__init__(self)
        self.cfg, self.mesh = full.cfg, mesh
        self.appearance_projection = None
        for name, child in full.named_children():
            setattr(self, name, copy.deepcopy(child))
        with torch.no_grad():
            for name, p in list(self.named_parameters()):
                mod_name, attr = name.rsplit(".", 1)
                setattr(self.get_submodule(mod_name), attr,
                        nn.Parameter(_shard(p, name, mesh), requires_grad=p.requires_grad))

    def _trunk(self, enc_x: torch.Tensor, cdt) -> torch.Tensor:
        group = self.mesh.model_group
        h = enc_x
        for i, layer in enumerate(self.pts_linears):
            if i in self.cfg.skip_connect_layers and i > 0:
                h = torch.cat([h, enc_x], dim=-1)
            if i % 2 == 0:
                h = F.relu(_linear(layer, _ToModelParallel.apply(h, group), cdt))
            else:
                w = layer.weight.to(cdt).to(torch.float32)
                part = F.linear(h.to(cdt).to(torch.float32), w)
                h = F.relu(_FromModelParallel.apply(part, group) + layer.bias)
        if len(self.pts_linears) % 2:
            h = _GatherFromModelParallel.apply(h, self.mesh)
        return h


def gather_model(model) -> NeRF:
    """The whole ``NeRF`` module of a ``TPNeRF`` on every rank of its model
    group (a plain module is returned as it is): gather, then convert
    (``utils/convert.params_to_jax``) or save."""
    if not isinstance(model, TPNeRF):
        return model
    full = NeRF(model.cfg).to(model.density_head.weight.device)
    with torch.no_grad():
        sd = {n: _unshard(p, n, model.mesh) for n, p in model.named_parameters()}
        full.load_state_dict(sd)
    return full


def _state_vector(model, table, optimizer, scheduler, generator, device) -> torch.Tensor:
    """One f32 vector of the training state: parameters, table, Adam's
    tensors, StepLR's count and the generator's state."""
    parts = [p.detach().reshape(-1).float() for p in model.parameters()]
    if table is not None:
        parts.append(table.detach().reshape(-1))
    for st in optimizer.state.values():
        parts += [v.detach().reshape(-1).float() for v in st.values()
                  if isinstance(v, torch.Tensor)]
    parts.append(torch.tensor([float(scheduler.last_epoch)]))
    if generator is not None:
        parts.append(generator.get_state().float())
    return torch.cat([x.to(device) for x in parts])


def shard_train_state(model, table, optimizer, scheduler, generator, mesh: Mesh,
                      tensor_parallel: bool = False):
    """Place the training state on the mesh; returns (model, table,
    optimizer, scheduler).

    Every rank builds the same state from the seed (or restores it from one
    checkpoint); it is broadcast from rank 0 and compared, so that a rank
    that differs raises instead of training apart.  Pure data parallelism
    keeps everything as it is (replicated).  With ``tensor_parallel`` the
    module becomes this rank's ``TPNeRF`` and Adam, with StepLR, is rebuilt
    over its parameters, each moment sliced as its parameter."""
    from danerf_tpu_torch.train.trainer import _set_rate, make_optimizer

    mine = _state_vector(model, table, optimizer, scheduler, generator, mesh.device)
    ref = mine.clone()
    dist.broadcast(ref, 0)
    bad = torch.ne(ref, mine).any().float().reshape(1)
    dist.all_reduce(bad)
    if float(bad) > 0:
        raise RuntimeError("the training state differs between ranks: every rank must start "
                           "from the same seed or checkpoint")
    if not tensor_parallel:
        return model, table, optimizer, scheduler
    tp = TPNeRF(model, mesh)
    params = list(tp.parameters()) + ([table] if table is not None else [])
    opt, sched = make_optimizer(model.cfg, params)
    names = [n for n, _ in model.named_parameters()] + ["appearance"]
    for name, old, new in zip(names, optimizer.param_groups[0]["params"], params):
        st = optimizer.state.get(old)
        if st:
            opt.state[new] = {k: _shard(v, name, mesh) if k != "step" else v.clone()
                              for k, v in st.items()}
    sched.load_state_dict(scheduler.state_dict())
    lr = optimizer.param_groups[0]["lr"]
    opt.param_groups[0]["lr"] = lr.clone() if isinstance(lr, torch.Tensor) else lr
    _set_rate(opt, model.cfg)
    return tp, table, opt, sched


def gather_train_state(model, table, optimizer):
    """(module, optimizer) of the whole model from a tensor-parallel state,
    on every rank of the model group: the ``NeRF`` of ``gather_model`` and
    an Adam over its parameters and the table holding the gathered moments,
    as a single-process run holds them (what a checkpoint stores).  A
    data-parallel state is returned as it is."""
    if not isinstance(model, TPNeRF):
        return model, optimizer
    from danerf_tpu_torch.train.trainer import make_optimizer

    full = gather_model(model)
    params = list(full.parameters()) + ([table] if table is not None else [])
    opt, _ = make_optimizer(model.cfg, params)
    names = [n for n, _ in model.named_parameters()] + ["appearance"]
    for name, old, new in zip(names, optimizer.param_groups[0]["params"], params):
        st = optimizer.state.get(old)
        if st:
            opt.state[new] = {k: _unshard(v, name, model.mesh) if k != "step" else v.clone()
                              for k, v in st.items()}
    opt.param_groups[0]["lr"] = optimizer.param_groups[0]["lr"]
    return full, opt


def replicate_pool(pool: dict, mesh: Mesh) -> dict:
    """The ray pool, which every rank loads itself (rays are sampled on the
    device per step, so each rank needs the whole pool): a checksum of each
    tensor is gathered over all ranks, and a pool that differs from rank
    0's raises.  Returns ``pool``."""
    sums = []
    for key in sorted(pool):
        x = pool[key].detach().reshape(-1).double()
        w = torch.arange(x.numel(), device=x.device, dtype=torch.float64) % 251 + 1
        sums += [x.sum(), (x * w).sum()]
    rank, world = _rank_world()
    table = torch.zeros(world, len(sums), dtype=torch.float64, device=mesh.device)
    table[rank] = torch.stack(sums).to(mesh.device)
    dist.all_reduce(table)
    if not bool((table == table[0]).all()):
        raise RuntimeError("the ray pools differ between ranks: every rank must load the "
                           "same scene")
    return pool


# ------------------------------------------------------------ sharded steps

def sharded_step(model, table, optimizer, cfg: NeRFConfig, mesh: Mesh, batch: dict, draws,
                 full: Optional[NeRF] = None) -> dict:
    """One data-parallel training step on a global ``batch`` and its global
    jitter ``draws`` (stratified (B, Sc), importance (B, Sf) or None), the
    same on every rank: this rank's block of rays through the path's
    ``compute_loss_and_grads``, one all-reduce over the data group of one
    flat buffer (every gradient, module and table, then the loss and the
    mses) divided by the data size, the rate, one Adam step.  On the kernel
    route of a ``TPNeRF``, ``full`` is a whole ``NeRF`` into which the trunk
    shards are gathered first; each rank then keeps its shard's slice of the
    averaged gradient.  Returns loss / psnr / mse / [coarse_mse] as device
    tensors."""
    from danerf_tpu_torch.train.metrics import psnr
    from danerf_tpu_torch.train.trainer import _set_rate, compute_loss_and_grads

    n = batch["rays_o"].shape[0]
    if n % mesh.data:
        raise ValueError(f"a batch of {n} rays does not split over data={mesh.data}")
    blk = mesh.share(n)
    local = {k: v[blk] for k, v in batch.items()}
    u_strat, u_imp = draws
    local_draws = (u_strat[blk], None if u_imp is None else u_imp[blk])
    params = optimizer.param_groups[0]["params"]
    optimizer.zero_grad(set_to_none=False)
    net = model
    if full is not None:
        with torch.no_grad():
            for (name, p), q in zip(model.named_parameters(), full.parameters()):
                q.copy_(_unshard(p, name, mesh))
        full.zero_grad(set_to_none=False)
        net = full
    loss, aux = compute_loss_and_grads(net, table, cfg, local, draws=local_draws)
    tensors = list(net.parameters()) + ([table] if table is not None else [])
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in tensors]
    metrics = {"loss": loss, **aux}
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.stack(list(metrics.values()))])
    mesh.sum_data(flat).div_(mesh.data)
    names = [n for n, _ in model.named_parameters()] + ["appearance"]
    at = 0
    for name, p, g in zip(names, params, grads):
        avg = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
        if full is not None and _split_dim(name) is not None:
            dim = _split_dim(name)
            k = p.shape[dim]
            avg = avg.narrow(dim, mesh.model_index * k, k)
        if p.grad is None:
            p.grad = avg.clone()
        else:
            p.grad.copy_(avg)
    values = dict(zip(metrics, flat[at:]))
    _set_rate(optimizer, cfg)
    optimizer.step()
    return {"loss": values["loss"], "psnr": psnr(values["mse"]),
            **{k: v for k, v in values.items() if k != "loss"}}


def make_sharded_train_step(model, table, optimizer, scheduler, pool, cfg: NeRFConfig,
                            mesh: Mesh, height: int, width: int, focal,
                            batch_size: Optional[int] = None,
                            generator: Optional[torch.Generator] = None,
                            steps_per_call: int = 1):
    """``steps_per_call`` data-parallel steps a call (counterpart of the JAX
    ``make_sharded_train_step``; the arguments of the port's
    ``make_train_step`` plus the mesh, the state from ``shard_train_state``:
    a ``TPNeRF`` makes it tensor-parallel).  Each step draws the global
    batch (``batch_size`` rays, the config's by default) and its jitter
    from ``generator``, then runs ``sharded_step``.  On the card with
    ``steps_per_call > 1`` the steps are one CUDA-graph replay
    (``ChainedStep``; the warm-up step on copies runs the all-reduce, so the
    communicator exists before the capture, and NCCL's work joins the
    capture stream); a gloo group cannot be captured, and raises."""
    from danerf_tpu_torch.data.dataset import sample_ray_batch
    from danerf_tpu_torch.train.trainer import _warm_step, chain_steps

    dev = pool["images"].device
    on_cuda = dev.type == "cuda"
    if on_cuda and steps_per_call > 1 and dist.get_backend(mesh.data_group) != "nccl":
        raise ValueError(f"steps_per_call={steps_per_call} captures the steps' collectives "
                         f"into a CUDA graph, which the {dist.get_backend(mesh.data_group)} "
                         "backend cannot join: use NCCL, or steps_per_call=1")
    full = gather_model(model) if isinstance(model, TPNeRF) and cfg.use_kernels else None
    b = batch_size or cfg.batch_size

    def run(m, t, opt, gen):
        batch = sample_ray_batch(pool, cfg, height, width, focal, b, gen)
        u_strat = torch.rand(b, cfg.num_samples, generator=gen, device=dev)
        u_imp = (torch.rand(b, cfg.num_importance, generator=gen, device=dev)
                 if cfg.num_importance > 0 else None)
        return sharded_step(m, t, opt, cfg, mesh, batch, (u_strat, u_imp), full)

    return chain_steps(lambda: run(model, table, optimizer, generator),
                       lambda: _warm_step(model, table, cfg, pool, generator, run),
                       steps_per_call, optimizer, scheduler, generator, cfg, on_cuda)


def make_sharded_render(cfg: NeRFConfig, mesh: Mesh, height: int, width: int, n_samples: int,
                        n_importance: int):
    """Rays rendered with each rank taking its contiguous share along the
    data axis, through ``render_rays`` without ``fused_composite`` (the
    per-sample route: K1 under ``cfg.use_kernels``); the results are
    gathered on every rank.  The returned ``render(model, rays_o, rays_d,
    emb=None, perturb=False, generator=None)`` gives (rgb, depth, acc) of
    all rays; under ``perturb`` the jitter of all rays is drawn from
    ``generator`` on every rank and each takes its share's."""
    from danerf_tpu_torch.render.renderer import render_rays

    def render(model, rays_o, rays_d, emb=None, perturb=False, generator=None):
        n = rays_o.shape[0]
        sl = mesh.share(n)
        draws = None
        if perturb:
            u_strat = torch.rand(n, n_samples, generator=generator, device=rays_o.device)
            u_imp = (torch.rand(n, n_importance, generator=generator, device=rays_o.device)
                     if n_importance > 0 else None)
            draws = (u_strat[sl], None if u_imp is None else u_imp[sl])
        out = torch.zeros(n, 5, device=rays_o.device)
        if sl.stop > sl.start:
            got = render_rays(model, cfg, rays_o[sl], rays_d[sl],
                              None if emb is None else emb[sl], n_samples=n_samples,
                              n_importance=n_importance, perturb=perturb,
                              fused_composite=False, draws=draws)
            out[sl] = torch.cat([got["rgb"], got["depth"][:, None], got["acc"][:, None]], -1)
        mesh.sum_data(out)
        return out[:, :3], out[:, 3], out[:, 4]

    return render
