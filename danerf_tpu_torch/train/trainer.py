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
  coarse backward, fed K4's coarse-field cotangent plus the coarse MSE's.
  Without (``num_importance=0``), ``_onepass_loss_grads``: one K7 launch.
- otherwise ``loss_fn`` and autograd.  On the kernel route
  (``use_kernels``, e.g. with a white background) ``render_rays`` runs K2,
  ``sample_pdf`` and K5 forward, and the backward K6 and then K3 (K2/K3
  alone without importance samples); on the reference route
  (``--no_pallas``) the module's forward at every sample and
  ``composite``.
On CPU tensors the kernels' plain versions run in their place.

Random draws (batch, stratified jitter, importance jitter, in that order)
come from one ``torch.Generator`` on the device, seeded from ``seed``;
coarse-only training draws no importance jitter.  The loss functions also
take the jitter as tensors (``draws``) so the tests can feed in the JAX
package's draws.  No step synchronises with the host: metrics stay on
the device and are written every ``LOG_FLUSH`` steps.
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
    stepped after every optimizer step."""
    opt = torch.optim.Adam(params, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)
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
    the coarse MSE when a fine pass runs; ``render_rays`` takes the kernel
    route when ``cfg.use_kernels`` (its backward K6/K3), else the reference
    route.  Differentiated by autograd."""
    from danerf_tpu_torch.render.renderer import render_rays

    emb = _embedding(table, cfg, batch)
    bg = (1.0, 1.0, 1.0) if cfg.white_background else None
    out = render_rays(model, cfg, batch["rays_o"], batch["rays_d"], appearance_embedding=emb,
                      t=batch.get("t"), perturb=True, background_color=bg,
                      fused_composite=cfg.use_kernels, generator=generator, draws=draws)
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
    against the raw composite, with no background fill for acc < 1."""
    return cfg.use_kernels and not cfg.use_time and not cfg.white_background


def compute_loss_and_grads(model, table, cfg: NeRFConfig, batch, generator=None, draws=None):
    """Loss and gradients (left in ``.grad``) by the route the config asks
    for; returns (loss, aux) as detached device tensors."""
    if cfg.use_time:
        if cfg.use_kernels:
            raise NotImplementedError(
                "use_time training on the kernel route is not yet ported: it needs the "
                "has_time variants of K2-K6 (the encoded time at the input and at each skip)")
        raise NotImplementedError("use_time training is not yet ported (its scene is not)")
    if use_onepass(cfg):
        if cfg.num_importance > 0:
            return _onepass_hier_loss_grads(model, table, cfg, batch, generator, draws)
        return _onepass_loss_grads(model, table, cfg, batch, generator, draws)
    loss, aux = loss_fn(model, table, cfg, batch, generator, draws)
    loss.backward()
    return loss.detach(), {k: v.detach() for k, v in aux.items()}


def train_step(model, table, optimizer, scheduler, pool, cfg: NeRFConfig, height: int,
               width: int, focal, batch_size: Optional[int] = None,
               generator: Optional[torch.Generator] = None) -> dict:
    """Batch draw, loss and gradients, one Adam step, one StepLR step.
    Returns loss / mse / [coarse_mse] / psnr as device tensors."""
    batch = sample_ray_batch(pool, cfg, height, width, focal, batch_size, generator)
    optimizer.zero_grad(set_to_none=True)
    loss, aux = compute_loss_and_grads(model, table, cfg, batch, generator)
    optimizer.step()
    scheduler.step()
    return {"loss": loss, "psnr": psnr(aux["mse"]), **aux}


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
          num_iterations: Optional[int] = None, seed: int = 0, device="cuda",
          checkpoint_every: int = 1000, log_path: Optional[str] = None,
          progress: bool = True):
    """The training loop (reference ``train_nerf``, src/train.py:13-207):
    ``warmup_iters`` steps at ``warmup_batch_size`` rays, then
    ``batch_size``; a checkpoint every ``checkpoint_every`` steps and a
    final one (``checkpoint_NNNNNN.pt``, ``checkpoint_final.pt``).

    Returns (model, table, logger)."""
    from danerf_tpu_torch.utils.checkpoint import save_checkpoint

    dev = resolve_device(device)
    os.makedirs(save_dir, exist_ok=True)
    n_iters = num_iterations if num_iterations is not None else cfg.num_iterations
    model, table = init_model(cfg, dataset.n_images, seed, dev)
    params = list(model.parameters()) + ([table] if table is not None else [])
    optimizer, scheduler = make_optimizer(cfg, params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = dataset.device_arrays(cfg.white_background, dev)
    h, w, focal = dataset.height, dataset.width, dataset.focal

    logger = MetricsLogger(log_path)
    pending: list = []
    metrics: dict = {}

    def flush():
        for j, m in pending:
            logger.log(j, **{k: float(v) for k, v in m.items()})
        pending.clear()

    def checkpoint(name, step):
        flush()
        last = logger.history[-1] if logger.history else {}
        save_checkpoint(os.path.join(save_dir, name), model, table, optimizer, scheduler,
                        iteration=step, loss=last.get("loss"), psnr=last.get("psnr"))

    t0 = time.time()
    for i in range(n_iters):
        bs = min(cfg.warmup_batch_size, cfg.batch_size) if i < cfg.warmup_iters else None
        metrics = train_step(model, table, optimizer, scheduler, pool, cfg, h, w, focal, bs, gen)
        step = i + 1
        pending.append((step, metrics))
        if len(pending) >= LOG_FLUSH:
            flush()
        if progress and (step % 1000 == 0 or step == n_iters):
            flush()
            last = logger.history[-1]
            rays_s = cfg.batch_size * step / max(time.time() - t0, 1e-9)
            print(f"step {step}/{n_iters} loss={last['loss']:.5f} psnr={last['psnr']:.2f} "
                  f"rays/s={rays_s:,.0f}", flush=True)
        if checkpoint_every and step % checkpoint_every == 0:
            checkpoint(f"checkpoint_{step:06d}.pt", step)
    checkpoint("checkpoint_final.pt", n_iters)
    logger.close()
    return model, table, logger
