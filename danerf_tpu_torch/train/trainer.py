"""Training (counterpart of danerf_tpu/train/trainer.py): Adam over the
module's parameters and the appearance table, lr 5e-4 halved every 10k
steps (StepLR), MSE over a 1024-ray batch (64 for the first 5 steps), PSNR
logging, checkpoints.

``compute_loss_and_grads`` takes the route the config asks for, as the
JAX package's does:
- ``use_onepass(cfg)`` (kernels, black background, no time): the one-pass
  losses, whose kernels compute the MSE and all of its gradients at once.
  With importance samples, ``_onepass_hier_loss_grads``: K2 marches the
  coarse samples and keeps their field, ``sample_pdf`` draws the importance
  depths, K4 computes the fine MSE with its whole backward, and K3 runs the
  coarse backward, fed K4's coarse-field cotangent plus the coarse MSE's;
  with ``use_hier_onepass``, ``_onepass_hier_fused_loss_grads``: one K9
  launch, which does all of that and inverts the coarse weights' CDF
  itself.  Without (``num_importance=0``), ``_onepass_loss_grads``: one K7
  launch.
- otherwise ``loss_fn`` and autograd.  On the fused kernel route
  (``use_kernels``, with a white background or with ``use_time``)
  ``render_rays`` runs K2, ``sample_pdf`` and K5 forward, and the backward
  K6 and then K3 (K2/K3 alone without importance samples); under
  ``use_time`` the batch's per-ray times ``t`` go to every kernel (their
  has_time variants); on the per-sample kernel route
  (``use_kernels`` with ``use_fused_train=False``) K1 at the coarse samples,
  ``composite``, ``sample_pdf``, K1 at the sorted union, ``composite``, and
  K8 for both K1 calls in the backward; on the reference route
  (``--no_pallas``) the module's forward at every sample and ``composite``.
On CPU tensors the kernels' plain versions run in their place.

Random draws (batch, stratified jitter, importance jitter, in that order)
come from one ``torch.Generator`` on the device, seeded from ``seed``;
coarse-only training draws no importance jitter.  The loss functions also
take the jitter as tensors (``draws``) so the tests can feed in the JAX
package's draws.  No step synchronises with the host: metrics stay on
the device and are written every ``LOG_FLUSH`` steps.

``make_train_step`` runs ``steps_per_call`` steps a call, the counterpart of
the JAX ``fori_loop``: on the card, one replay of a CUDA graph captured from
those steps (``ChainedStep``); on the CPU, eagerly.  ``train`` chains 10
steps a call by default, resumes the whole state of a checkpoint
(``resume``), and writes a validation render at each checkpoint and the
training curves at the end.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch
from torch import nn

from danerf_tpu_torch import resolve_device
from danerf_tpu_torch.config import NeRFConfig
from danerf_tpu_torch.data.dataset import RayDataset, sample_ray_batch
from danerf_tpu_torch.models.nerf import NeRF, init_appearance_embeddings
from danerf_tpu_torch.train.metrics import MetricsLogger, psnr

LOG_FLUSH = 10   # steps between metric writes (each write waits for the device)


def lr_schedule(cfg: NeRFConfig):
    """StepLR's rate at a step count (optax's exponential_decay with
    staircase=True, evaluated at the count of earlier updates)."""
    return lambda step: cfg.learning_rate * cfg.scheduler_gamma ** (step // cfg.scheduler_step_size)


def make_optimizer(cfg: NeRFConfig, params):
    """Adam (beta 0.9/0.999, eps 1e-8) over ``params`` (the module's
    parameters and the dense appearance table) and the StepLR that is
    stepped after every optimizer step.

    On CUDA parameters Adam is ``capturable`` (its step counts stay on the
    device, so a captured step can run it) and its rate is a device tensor,
    which every step sets from Adam's count of earlier steps
    (``_set_rate``): a rate held as a Python float would be frozen into a
    captured graph.  On the CPU the rate is the float StepLR keeps."""
    params = list(params)
    dev = params[0].device
    lr = torch.tensor(cfg.learning_rate, device=dev) if dev.type == "cuda" else cfg.learning_rate
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=dev.type == "cuda")
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=cfg.scheduler_step_size,
                                            gamma=cfg.scheduler_gamma)
    return opt, sched


def _bounds(cfg: NeRFConfig, rays_o, rays_d):
    if cfg.scene_aabb is None:
        return cfg.near, cfg.far
    from danerf_tpu_torch.ops.sampling import ray_aabb_bounds

    box = cfg.scene_aabb
    return ray_aabb_bounds(rays_o, rays_d, box[:3], box[3:], cfg.near, cfg.far)


def _draws(cfg: NeRFConfig, n: int, generator, draws, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(stratified jitter (n, Sc), importance jitter (n, Sf)): the given
    ``draws``, or two draws from ``generator``, in that order."""
    if draws is not None:
        return draws
    return (torch.rand(n, cfg.num_samples, generator=generator, device=device),
            torch.rand(n, cfg.num_importance, generator=generator, device=device))


def _embedding(table, cfg: NeRFConfig, batch):
    """The batch's rows of the appearance table (a gather, whose backward
    scatter-adds the per-ray gradients into the table)."""
    if not cfg.use_appearance or table is None:
        return None
    return table[batch["img_idx"]]


def loss_fn(model, table, cfg: NeRFConfig, batch, generator=None, draws=None):
    """MSE of the rendered rgb against the target, plus coarse_loss_weight x
    the coarse MSE when a fine pass runs; ``render_rays`` takes the fused
    route when ``cfg.use_kernels and cfg.use_fused_train`` (its backward
    K6/K3), else the per-sample route (K1/K8 under ``cfg.use_kernels``, the
    module's forward without); the batch's times go in under
    ``cfg.use_time`` only.  Differentiated by autograd."""
    from danerf_tpu_torch.render.renderer import render_rays

    emb = _embedding(table, cfg, batch)
    bg = (1.0, 1.0, 1.0) if cfg.white_background else None
    out = render_rays(model, cfg, batch["rays_o"], batch["rays_d"], appearance_embedding=emb,
                      t=batch.get("t") if cfg.use_time else None, perturb=True,
                      background_color=bg,
                      fused_composite=cfg.use_kernels and cfg.use_fused_train,
                      generator=generator, draws=draws)
    loss = torch.mean((out["rgb"] - batch["rgb"]) ** 2)
    aux = {"mse": loss}
    if "coarse_rgb" in out and cfg.coarse_loss_weight > 0:
        coarse = torch.mean((out["coarse_rgb"] - batch["rgb"]) ** 2)
        loss = loss + cfg.coarse_loss_weight * coarse
        aux["coarse_mse"] = coarse
    return loss, aux


def _onepass_inputs(model, table, cfg: NeRFConfig, batch, u_strat):
    """What both one-pass losses start from: the unit directions, the
    stratified depths at jitter ``u_strat``, the batch's embedding rows
    (zeros without appearance), the weights packed once for every kernel of
    the step, and the module's (names, parameters)."""
    from danerf_tpu_torch.kernels.fused_mlp import pack_params
    from danerf_tpu_torch.kernels.fused_render import module_params
    from danerf_tpu_torch.ops.sampling import sample_stratified

    rays_o = batch["rays_o"]
    rays_d = batch["rays_d"] / torch.linalg.norm(batch["rays_d"], dim=-1, keepdim=True)
    near, far = _bounds(cfg, rays_o, rays_d)
    z_c, _ = sample_stratified(rays_o, rays_d, near, far, cfg.num_samples, True, rand=u_strat)
    emb = _embedding(table, cfg, batch)
    packed = pack_params(model, cfg, appearance=emb is not None, device=rays_o.device)
    if emb is None:
        emb = torch.zeros(rays_o.shape[0], cfg.appearance_dim, device=rays_o.device)
    return rays_d, z_c, emb, packed, module_params(model)


def _onepass_hier_loss_grads(model, table, cfg: NeRFConfig, batch, generator=None,
                             draws=None):
    """Hierarchical training through the kernels; leaves the gradients in
    ``.grad`` and returns (loss, {"mse", "coarse_mse"}).

    Autograd sums K4's ``g_field`` with the coarse MSE's cotangent and hands
    both to K3; the embedding gather scatter-adds demb_f + demb_c into the
    table."""
    from danerf_tpu_torch.kernels.fused_render import MarchFn, MergedTrainLossFn
    from danerf_tpu_torch.ops.sampling import sample_pdf

    rays_o, target = batch["rays_o"], batch["rgb"]
    u_strat, u_imp = _draws(cfg, rays_o.shape[0], generator, draws, rays_o.device)
    rays_d, z_c, emb, packed, (names, params) = _onepass_inputs(model, table, cfg, batch,
                                                                u_strat)
    rgb_c, _, _, w_c, field_c = MarchFn.apply(cfg, packed, names, True, rays_o, rays_d, emb,
                                              z_c, None, *params)
    z_f = sample_pdf(z_c, w_c.detach(), cfg.num_importance, True, rand=u_imp).detach()
    mse_fine = MergedTrainLossFn.apply(cfg, packed, names, rays_o, rays_d, emb, z_c, field_c,
                                       z_f, target, None, *params)
    mse_coarse = torch.mean((rgb_c - target) ** 2)
    loss = mse_fine + cfg.coarse_loss_weight * mse_coarse
    loss.backward()
    return loss.detach(), {"mse": mse_fine.detach(), "coarse_mse": mse_coarse.detach()}


def _onepass_hier_fused_loss_grads(model, table, cfg: NeRFConfig, batch, generator=None,
                                   draws=None):
    """Hierarchical training in one kernel (K9); leaves the gradients in
    ``.grad`` and returns (loss, {"mse", "coarse_mse"}).

    The same two draws as ``_onepass_hier_loss_grads``: the importance
    uniforms u are ``importance_uniforms`` of the second, which is exactly
    what ``sample_pdf`` inverts the CDF at in the two-kernel step, so the
    two routes see the same numbers.  The embedding gather's backward
    scatter-adds demb into the table."""
    from danerf_tpu_torch.kernels.fused_render import HierOnepassLossFn
    from danerf_tpu_torch.ops.sampling import importance_uniforms

    rays_o, target = batch["rays_o"], batch["rgb"]
    n = rays_o.shape[0]
    u_strat, u_imp = _draws(cfg, n, generator, draws, rays_o.device)
    rays_d, z_c, emb, packed, (names, params) = _onepass_inputs(model, table, cfg, batch,
                                                                u_strat)
    u = importance_uniforms((n,), cfg.num_importance, True, rand=u_imp, device=rays_o.device)
    loss, mse_f, mse_c = HierOnepassLossFn.apply(cfg, packed, names, rays_o, rays_d, emb, z_c,
                                                 u, target, None, *params)
    loss.backward()
    return loss.detach(), {"mse": mse_f, "coarse_mse": mse_c}


def _onepass_loss_grads(model, table, cfg: NeRFConfig, batch, generator=None, draws=None):
    """Coarse-only training in one kernel (K7); leaves the gradients in
    ``.grad`` and returns (mse, {"mse"}).

    Only the stratified jitter is drawn (the JAX function's key split, of
    which it uses the first half): ``draws`` is that tensor, or a 1-tuple of
    it.  The embedding gather's backward scatter-adds demb into the table."""
    from danerf_tpu_torch.kernels.fused_render import MarchTrainLossFn

    rays_o, target = batch["rays_o"], batch["rgb"]
    if draws is None:
        u_strat = torch.rand(rays_o.shape[0], cfg.num_samples, generator=generator,
                             device=rays_o.device)
    else:
        u_strat = draws[0] if isinstance(draws, (tuple, list)) else draws
    rays_d, z, emb, packed, (names, params) = _onepass_inputs(model, table, cfg, batch,
                                                              u_strat)
    mse = MarchTrainLossFn.apply(cfg, packed, names, rays_o, rays_d, emb, z, target, None,
                                 *params)
    mse.backward()
    return mse.detach(), {"mse": mse.detach()}


def use_onepass(cfg: NeRFConfig) -> bool:
    """True when the one-pass training kernels (K7, K4) serve this config.

    A white background takes ``loss_fn``'s route instead (K2, K5 forward;
    K6, K3 backward): the one-pass kernels form the MSE in the kernel
    against the raw composite, with no background fill for acc < 1.  So
    does ``use_time``, as in the JAX package.  ``use_fused_train=False``
    takes ``loss_fn``'s per-sample route (K1, K8)."""
    return (cfg.use_kernels and cfg.use_fused_train and not cfg.use_time
            and not cfg.white_background)


def compute_loss_and_grads(model, table, cfg: NeRFConfig, batch, generator=None, draws=None):
    """Loss and gradients (left in ``.grad``) by the route the config asks
    for; returns (loss, aux) as detached device tensors.  Under
    ``cfg.use_time`` the batch carries ``t`` (B, 1)."""
    if cfg.use_time and batch.get("t") is None:
        raise ValueError("cfg.use_time=True requires the batch's per-ray times (batch['t'])")
    if use_onepass(cfg):
        if cfg.num_importance > 0:
            if cfg.use_hier_onepass:
                return _onepass_hier_fused_loss_grads(model, table, cfg, batch, generator, draws)
            return _onepass_hier_loss_grads(model, table, cfg, batch, generator, draws)
        return _onepass_loss_grads(model, table, cfg, batch, generator, draws)
    loss, aux = loss_fn(model, table, cfg, batch, generator, draws)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def _set_rate(optimizer, cfg: NeRFConfig) -> None:
    """Where the rate is a device tensor (CUDA), set it to StepLR's rate for
    this step, lr * gamma ** (n // step_size) with n Adam's count of earlier
    steps, on the device: a captured step then reads the rate of the step it
    replays.  Before the first step (no Adam state) the rate is the initial
    one already."""
    group = optimizer.param_groups[0]
    lr = group["lr"]
    state = optimizer.state.get(group["params"][0])
    if not isinstance(lr, torch.Tensor) or not state:
        return
    n = torch.div(state["step"], cfg.scheduler_step_size, rounding_mode="floor")
    torch.mul(torch.pow(cfg.scheduler_gamma, n), cfg.learning_rate, out=lr)


def _step_scheduler(optimizer, scheduler, cfg: NeRFConfig, k: int = 1) -> None:
    """StepLR's host-side step for each of the last ``k`` optimizer steps,
    then, on the device path, the rate of the next step from Adam's count
    (``_set_rate``): how StepLR itself updates a tensor rate differs between
    PyTorch versions, so the optimizer's rate is always the formula's, after
    eager steps and after a replay alike."""
    for _ in range(k):
        scheduler.step()
    _set_rate(optimizer, cfg)


def _step(model, table, optimizer, pool, cfg: NeRFConfig, height: int, width: int, focal,
          batch_size: Optional[int], generator: Optional[torch.Generator]) -> dict:
    """One step without StepLR's host-side step: batch draw, loss and
    gradients, the rate, one Adam step, all on the pool's device.  The
    gradients are zeroed in place, so that a captured step finds the same
    ``.grad`` tensors on every replay."""
    batch = sample_ray_batch(pool, cfg, height, width, focal, batch_size, generator)
    optimizer.zero_grad(set_to_none=False)
    loss, aux = compute_loss_and_grads(model, table, cfg, batch, generator)
    _set_rate(optimizer, cfg)
    optimizer.step()
    return {"loss": loss, "psnr": psnr(aux["mse"]), **aux}


def train_step(model, table, optimizer, scheduler, pool, cfg: NeRFConfig, height: int,
               width: int, focal, batch_size: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> dict:
    """Batch draw, loss and gradients, one Adam step, one StepLR step.
    Returns loss / psnr / mse / [coarse_mse] as device tensors."""
    metrics = _step(model, table, optimizer, pool, cfg, height, width, focal, batch_size,
                    generator)
    _step_scheduler(optimizer, scheduler, cfg)
    return metrics


def _stack(steps):
    """The metrics of consecutive steps as (names, one (k, n_names) device
    tensor)."""
    names = list(steps[0])
    return names, torch.stack([torch.stack([m[n] for n in names]) for m in steps])


def _columns(names, mat) -> dict:
    """{name: (k,) tensor}: the columns of ``_stack``'s tensor."""
    return {n: mat[:, j] for j, n in enumerate(names)}


def _ready_for_capture(optimizer) -> None:
    """Allocate before a capture what a captured step must find in place:
    each parameter's ``.grad`` (zeroed in place by every step) and Adam's
    state, as Adam's first step creates it (a zero count and zero moments).
    Created inside the graph instead, both would be created anew on every
    replay."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            state = optimizer.state[p]
            if not state:
                state["step"] = torch.zeros((), dtype=torch.float32, device=p.device)
                state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)


def _warm_step(model, table, cfg: NeRFConfig, pool, generator: Optional[torch.Generator],
               run) -> None:
    """One training step, ``run(model, table, optimizer, generator)``, on
    copies of the module, the table, a fresh Adam and the generator: it runs
    what the step runs and leaves the training state as it was."""
    import copy

    model = copy.deepcopy(model)
    table = None if table is None else copy.deepcopy(table)
    params = list(model.parameters()) + ([table] if table is not None else [])
    optimizer, _ = make_optimizer(cfg, params)
    gen = torch.Generator(device=pool["images"].device)
    if generator is not None:
        gen.set_state(generator.get_state())
    run(model, table, optimizer, gen)


class ChainedStep:
    """``k`` training steps as one CUDA graph: the counterpart of the JAX
    package's ``fori_loop`` over ``steps_per_call`` steps (one device
    program, one host dispatch).

    The first call captures the k steps (batch draws, losses and gradients
    through the path's kernels, rates, Adam), the seeded generator
    registered with the graph so that every replay advances it as k eager
    steps would; every call replays the graph, steps StepLR k times on the
    host (``_step_scheduler``) and returns the k steps' metrics as in
    ``make_train_step``, copied out of the graph's output by one device op.
    Before capturing, ``warm`` runs one step on copies (``_warm_step``):
    whatever initialises on first use (a kernel's library and module, its
    shared-memory attribute, PyTorch's workspaces) does so outside the
    capture, and the training state is not touched.  Neither warm-up nor capture counts as launches:
    the launches the wrappers count while capturing are taken back and
    added again on every replay (``launches``: per replay).  ``pool_bytes``
    is the device memory the capture reserved (the graph's private pool:
    every intermediate and scratch buffer of the k steps).  A failed
    capture or replay raises; nothing falls back to eager steps."""

    def __init__(self, step, warm, k: int, optimizer, scheduler, generator, cfg: NeRFConfig):
        self.step, self.warm, self.k, self.cfg = step, warm, k, cfg
        self.optimizer, self.scheduler, self.generator = optimizer, scheduler, generator
        self.graph = None
        self.launches: dict = {}
        self.pool_bytes = 0

    def capture(self) -> None:
        from danerf_tpu_torch.kernels.fused_mlp import LAUNCHES

        dev = self.optimizer.param_groups[0]["params"][0].device
        before = dict(LAUNCHES)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.warm()
        torch.cuda.current_stream(dev).wait_stream(side)
        LAUNCHES.update(before)
        _ready_for_capture(self.optimizer)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # thread_local: only this thread's calls are checked while capturing
        # (a data-parallel step's NCCL watchdog thread queries events then)
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.names, self.out = _stack([self.step() for _ in range(self.k)])
        self.launches = {n: LAUNCHES[n] - before[n] for n in LAUNCHES}
        LAUNCHES.update(before)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.graph = graph

    def __call__(self) -> dict:
        from danerf_tpu_torch.kernels.fused_mlp import LAUNCHES

        if self.graph is None:
            self.capture()
        self.graph.replay()
        for n, c in self.launches.items():
            LAUNCHES[n] += c
        _step_scheduler(self.optimizer, self.scheduler, self.cfg, self.k)
        return _columns(self.names, self.out.clone())


def chain_steps(step, warm, steps_per_call: int, optimizer, scheduler, generator, cfg: NeRFConfig,
                on_cuda: bool):
    """``steps_per_call`` calls of ``step`` (one training step without
    StepLR's host-side step) a call, returning their metrics as
    {name: (steps_per_call,) device tensor}: on CUDA with ``steps_per_call >
    1`` a ``ChainedStep`` (``warm`` runs one step on copies before the
    capture), otherwise eagerly, StepLR stepped after each step."""
    if on_cuda and steps_per_call > 1:
        return ChainedStep(step, warm, steps_per_call, optimizer, scheduler, generator, cfg)

    def eager():
        out = []
        for _ in range(steps_per_call):
            out.append(step())
            _step_scheduler(optimizer, scheduler, cfg)
        return _columns(*_stack(out))

    return eager


def make_train_step(model, table, optimizer, scheduler, pool, cfg: NeRFConfig, height: int,
                    width: int, focal, batch_size: Optional[int] = None,
                    generator: Optional[torch.Generator] = None, steps_per_call: int = 1):
    """``steps_per_call`` training steps a call (counterpart of the JAX
    ``make_train_step``).  The returned callable takes no argument and
    returns the steps' metrics as {name: (steps_per_call,) device tensor},
    one entry per step, with no host sync.

    On a CUDA pool with ``steps_per_call > 1`` the steps are a
    ``ChainedStep``: captured on the first call, one graph replay on every
    call.  Otherwise (the CPU, or ``steps_per_call=1``) they run eagerly as
    ``train_step`` does."""
    def run(m, t, opt, gen):
        return _step(m, t, opt, pool, cfg, height, width, focal, batch_size, gen)

    return chain_steps(lambda: run(model, table, optimizer, generator),
                       lambda: _warm_step(model, table, cfg, pool, generator, run),
                       steps_per_call, optimizer, scheduler, generator, cfg,
                       pool["images"].device.type == "cuda")


def init_model(cfg: NeRFConfig, n_images: int, seed: int, device):
    """The module and the appearance table (an ``nn.Parameter``, or None
    without appearance), drawn on the CPU from ``seed`` so that a seed gives
    the same start on every device."""
    g = torch.Generator().manual_seed(seed)
    model = NeRF(cfg, g).to(device)
    table = None
    if cfg.use_appearance:
        table = nn.Parameter(init_appearance_embeddings(n_images, cfg.appearance_dim, g)
                             .to(device))
    return model, table


def train(cfg: NeRFConfig, dataset: RayDataset, save_dir: str = "checkpoints",
          resume: bool = False, log_path: Optional[str] = None, checkpoint_every: int = 1000,
          eval_every: int = 1, num_iterations: Optional[int] = None, seed: int = 0,
          device="cuda", progress: bool = True, steps_per_call: int = 10, mesh=None):
    """The training loop (reference ``train_nerf``, src/train.py:13-207; the
    JAX ``train``).

    ``warmup_iters`` steps singly at ``warmup_batch_size`` rays, then
    ``batch_size`` rays in chunks of ``steps_per_call`` steps
    (``make_train_step``: one graph replay a chunk on the card), never
    crossing a checkpoint: a chunk that would is run as single steps.  A
    checkpoint every ``checkpoint_every`` steps (``checkpoint_NNNNNN.pt``,
    then ``render_NNNNNN.png`` when ``eval_every``) and a final one
    (``checkpoint_final.pt``, then ``training_curves.png``).  ``resume``
    restores the whole state of ``latest_checkpoint(save_dir)`` (module,
    table, Adam, StepLR, the generator) and continues from its iteration.
    ``metrics.jsonl`` (``log_path``) gets one row a step, written every
    ``LOG_FLUSH`` steps or more, a chunk behind the device.

    With ``mesh`` (``parallel.make_mesh``) every rank runs this loop: the
    state is checked equal on every rank and placed on the mesh
    (``shard_train_state``: tensor-parallel when its model axis is > 1), the
    pool checked equal (``replicate_pool``), and each step is a
    ``make_sharded_train_step`` over the global batch.  Whenever several
    ranks run, rank 0 alone writes ``metrics.jsonl``, the checkpoints (of
    the whole model), the validation renders and the curves, and prints
    progress; under a mesh the others wait at a barrier after each
    checkpoint.  ``resume`` restores the same file on every rank.

    Returns (model, table, logger): a ``TPNeRF`` under tensor parallelism."""
    from danerf_tpu_torch.parallel.mesh import _rank_world
    from danerf_tpu_torch.utils.checkpoint import (latest_checkpoint, restore_training_state,
                                                   save_checkpoint)

    if cfg.use_time and dataset.times is None:
        raise ValueError(
            "cfg.use_time=True but the dataset has no per-image times: the time-conditioned "
            "variant needs a time channel (RayDataset.times).  The procedural time-varying "
            "scene has one (danerf_tpu_torch.data.synthetic.make_time_varying_scene); Blender "
            "scenes do not.")
    dev = resolve_device(device)
    writer = _rank_world()[0] == 0
    if writer:
        os.makedirs(save_dir, exist_ok=True)
    n_iters = num_iterations if num_iterations is not None else cfg.num_iterations
    model, table = init_model(cfg, dataset.n_images, seed, dev)
    params = list(model.parameters()) + ([table] if table is not None else [])
    optimizer, scheduler = make_optimizer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    start = 0
    if resume:
        path = latest_checkpoint(save_dir)
        if path is not None:
            start = restore_training_state(path, model, table, optimizer, scheduler, gen)
    pool = dataset.device_arrays(cfg.white_background, dev)
    h, w, focal = dataset.height, dataset.width, dataset.focal
    if mesh is None:
        def maker(k, batch_size=None):
            return make_train_step(model, table, optimizer, scheduler, pool, cfg, h, w, focal,
                                   batch_size, gen, k)
    else:
        from danerf_tpu_torch.parallel.mesh import (make_sharded_train_step, replicate_pool,
                                                    shard_train_state)

        pool = replicate_pool(pool, mesh)
        model, table, optimizer, scheduler = shard_train_state(
            model, table, optimizer, scheduler, gen, mesh, tensor_parallel=mesh.model > 1)

        def maker(k, batch_size=None):
            return make_sharded_train_step(model, table, optimizer, scheduler, pool, cfg, mesh,
                                           h, w, focal, batch_size, gen, k)

    step_full, step_single = maker(steps_per_call), maker(1)
    step_warm = maker(1, min(cfg.warmup_batch_size, cfg.batch_size))

    logger = MetricsLogger(log_path if writer else None)
    pending: list = []   # (step of the first row, {name: (k,) device tensor})

    def flush(keep: int = 0):
        n = len(pending) - keep
        for first, m in pending[:n]:
            for j, row in enumerate(torch.stack(list(m.values()), 1).tolist()):
                logger.log(first + j, **dict(zip(m, row)))
        del pending[:n]

    def checkpoint(name, step, render=False):
        """Write a checkpoint (and, with ``render``, its validation render)
        on rank 0; the whole model is gathered on every rank first."""
        from danerf_tpu_torch.parallel.mesh import gather_train_state

        flush()
        last = logger.history[-1] if logger.history else {}
        full, full_opt = gather_train_state(model, table, optimizer)
        if writer:
            save_checkpoint(os.path.join(save_dir, name), full, table, full_opt, scheduler,
                            iteration=step, loss=last.get("loss"), psnr=last.get("psnr"),
                            generator=gen)
            if render:
                _save_validation_render(full, table, cfg, dataset, save_dir, step, dev)
        if mesh is not None:
            import torch.distributed as dist

            dist.barrier()

    t0 = time.time()
    i = last_progress = start
    while i < n_iters:
        if i < cfg.warmup_iters:
            pending.append((i + 1, step_warm()))
            i += 1
        else:
            k = min(steps_per_call, n_iters - i)
            if checkpoint_every:
                k = min(k, checkpoint_every - i % checkpoint_every)
            if k == steps_per_call:
                pending.append((i + 1, step_full()))
            else:
                pending.extend((i + 1 + j, step_single()) for j in range(k))
            i += k
        # write the rows of all but the newest call, which the device may
        # still be running: the host waits for the call before it
        if pending[-1][0] - pending[0][0] >= LOG_FLUSH:
            flush(keep=1)
        if progress and writer and (i - last_progress >= 1000 or i == n_iters):
            last_progress = i
            flush()
            last = logger.history[-1]
            rays_s = cfg.batch_size * (i - start) / max(time.time() - t0, 1e-9)
            print(f"step {i}/{n_iters} loss={last['loss']:.5f} psnr={last['psnr']:.2f} "
                  f"rays/s={rays_s:,.0f}", flush=True)
        if checkpoint_every and i % checkpoint_every == 0:
            checkpoint(f"checkpoint_{i:06d}.pt", i, render=bool(eval_every))
    checkpoint("checkpoint_final.pt", n_iters)
    if writer:
        _save_training_curves(logger, save_dir)
    logger.close()
    return model, table, logger


def _save_validation_render(model, table, cfg: NeRFConfig, dataset, save_dir: str, step: int,
                            device, max_size: int = 128) -> None:
    """``render_{step:06d}.png``: the last view at most ``max_size`` pixels
    wide, rgb beside its viridis depth (the JAX ``_save_validation_render``;
    reference src/train.py:127-173 renders a 1000-ray strip).  A failure is
    printed: an eval render never ends training."""
    import numpy as np

    from danerf_tpu_torch.render.renderer import render_frame
    from danerf_tpu_torch.viz.depth import colorize_depth
    from danerf_tpu_torch.viz.png import write_png

    try:
        scale = max(1, max(dataset.height, dataset.width) // max_size)
        h, w = dataset.height // scale, dataset.width // scale
        emb = None
        if cfg.use_appearance and table is not None:
            emb = table.detach()[dataset.n_images - 1]
        rgb, depth, _ = render_frame(model, cfg, dataset.c2ws[-1], h, w, dataset.focal / scale,
                                     appearance_embedding=emb,
                                     n_importance=cfg.num_importance, perturb=False,
                                     device=device)
        rgb_u8 = np.clip(rgb.cpu().numpy() * 255, 0, 255).astype(np.uint8)
        strip = np.concatenate([rgb_u8, colorize_depth(depth.cpu().numpy())], axis=1)
        write_png(os.path.join(save_dir, f"render_{step:06d}.png"), strip)
    except Exception as e:  # eval renders must never kill training
        print(f"validation render failed at step {step}: {e}")


def _save_training_curves(logger: MetricsLogger, save_dir: str) -> None:
    """``training_curves.png``: loss and PSNR against the step (reference
    src/train.py:189-204), drawn by ``viz/curves.py``.  A failure is
    printed."""
    if not logger.history:
        return
    try:
        from danerf_tpu_torch.viz.curves import write_training_curves

        write_training_curves(os.path.join(save_dir, "training_curves.png"), logger.history)
    except Exception as e:
        print(f"training-curve plot failed: {e}")
