"""The reference's training semantics in plain PyTorch, on a chosen device
(the port's copy of ``benchmarks/torch_reference.py``).

This is the referee of the parity bar ("PSNR within 0.1 dB of the
reference implementation trained under the same config"): the reference
ships no trained checkpoint and no recorded PSNR, so the number comes from
running its semantics.  The formulas are those of the repository's
``benchmarks/torch_reference.py``, unchanged:

- model: 8x256 trunk with skip-concat, ReLU density head, view-dir branch at
  hidden//2, appearance embedding projected and ADDED to the dir feature,
  sigmoid RGB (reference src/models.py:57-162);
- ray grid: ((j - W/2)/f, -(i - H/2)/f, -1) rotated by c2w
  (src/ray_utils.py:26-48);
- stratified sampling with in-bin jitter (src/ray_utils.py:52-88);
- compositing: alpha = 1 - exp(-sigma*dists) with the 1e-3 tail distance,
  exclusive-cumprod transmittance with the 1e-10 floor (src/render.py:56-80);
- loop: Adam over model params + per-image appearance embeddings, MSE loss,
  warmup batch 64 for the first 5 iters, StepLR(10k, 0.5), PSNR =
  -10*log10(MSE) (src/train.py:26-104, config.py:3-36).

``num_importance > 0`` adds the fine pass the reference declares
(config.py:14, src/ray_utils.py:90-149): coarse weights -> inverse-CDF
resample -> union sort -> the same model on the union -> loss = mse(fine) +
coarse_loss_weight * mse(coarse).

What this copy adds is a device.  ``train_reference(..., device=)`` runs the
same program on the card or on the CPU:

- the init is drawn on the CPU from a ``torch.Generator`` seeded with
  ``seed``, in the order ``torch.manual_seed(seed)``, ``ReferenceNeRF(cfg)``
  and ``torch.randn(n_images, appearance_dim)`` draw it (``reference_init``),
  then moved to the device: a seed gives the repository script's init on
  every device, and the global generators are not touched;
- the ray grids and the stratified bins are computed on the CPU once and
  moved, so only the training arithmetic runs on the device;
- on the card it runs in f32 with TF32 off: it asserts
  ``torch.backends.cuda.matmul.allow_tf32 is False`` and
  ``torch.get_float32_matmul_precision() == "highest"``;
- no step waits for the device: each step's inputs go up from pinned memory
  and the per-step MSEs are read back every ``_FLUSH`` steps.

On the CPU a run is bit for bit the repository script's (run on one thread;
``tests/test_torch_parity_study.py``).  It launches none of the port's
kernels: it is the referee, not the port's path.

RNG protocol (shared with the repository script and the JAX mirror): all
per-step randomness is drawn from ONE ``np.random.default_rng(seed)`` in a
fixed order —
  1. img_idx = g.integers(0, n_images)
  2. sel     = g.choice(H*W, bs, replace=False)
  3. jitter  = g.random((bs, num_samples), dtype=float32)     [stratified]
  4. u_jit   = g.random((bs, num_importance), dtype=float32)  [hier only]
"""

from __future__ import annotations

import math

import numpy as np
import torch

from danerf_tpu_torch import resolve_device

_FLUSH = 100   # steps between reads of the per-step MSEs


def encode(x: torch.Tensor, levels: int) -> torch.Tensor:
    """gamma(x) = [x, sin(2^i x), cos(2^i x)] (reference src/models.py:6-54)."""
    outs = [x]
    for i in range(levels):
        f = 2.0 ** i
        outs += [torch.sin(f * x), torch.cos(f * x)]
    return torch.cat(outs, -1)


def _linear(fan_in: int, fan_out: int, generator) -> torch.nn.Linear:
    """``torch.nn.Linear(fan_in, fan_out)``; with ``generator`` its default
    init (``reset_parameters``: kaiming-uniform weight, then the bias) drawn
    from that generator instead of the global one."""
    if generator is None:
        return torch.nn.Linear(fan_in, fan_out)
    lin = torch.nn.Linear(fan_in, fan_out, device="meta").to_empty(device="cpu")
    with torch.no_grad():
        torch.nn.init.kaiming_uniform_(lin.weight, a=math.sqrt(5), generator=generator)
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        torch.nn.init.uniform_(lin.bias, -bound, bound, generator=generator)
    return lin


class ReferenceNeRF(torch.nn.Module):
    """The reference MLP (src/models.py:57-162), dims driven by a NeRFConfig;
    its layers initialised in construction order, from ``generator`` when
    one is given."""

    def __init__(self, cfg, generator=None):
        super().__init__()
        self.cfg = cfg
        pdim = 3 * (1 + 2 * cfg.pos_enc_levels)
        ddim = 3 * (1 + 2 * cfg.dir_enc_levels)
        H = cfg.hidden_dim
        self.layers = torch.nn.ModuleList([_linear(pdim, H, generator)])
        for i in range(1, cfg.num_layers):
            inp = H + pdim if i in cfg.skip_connect_layers else H
            self.layers.append(_linear(inp, H, generator))
        self.density = _linear(H, 1, generator)
        self.dir_layer = _linear(H + ddim, H // 2, generator)
        if cfg.use_appearance:
            self.app_proj = _linear(cfg.appearance_dim, H // 2, generator)
        self.rgb_layer = _linear(H // 2, 3, generator)

    def forward(self, pts, dirs, emb=None):
        cfg = self.cfg
        ex = encode(pts, cfg.pos_enc_levels)
        ed = encode(dirs, cfg.dir_enc_levels)
        h = ex
        for i, lin in enumerate(self.layers):
            if i in cfg.skip_connect_layers and i > 0:
                h = torch.cat([h, ex], -1)
            h = torch.relu(lin(h))
        sigma = torch.relu(self.density(h))[..., 0]
        hd = torch.relu(self.dir_layer(torch.cat([h, ed], -1)))
        if emb is not None:
            # projected and ADDED to the dir feature (src/models.py:146-156)
            hd = hd + self.app_proj(emb)
        return torch.sigmoid(self.rgb_layer(hd)), sigma


def reference_init(cfg, n_images: int, seed: int):
    """(model, emb) on the CPU: the init ``torch.manual_seed(seed)`` then
    ``ReferenceNeRF(cfg)`` and ``torch.randn(n_images, appearance_dim)``
    draw, taken from a generator of its own (emb None without
    appearance)."""
    g = torch.Generator().manual_seed(seed)
    model = ReferenceNeRF(cfg, g)
    emb = torch.randn(n_images, cfg.appearance_dim, generator=g) if cfg.use_appearance else None
    return model, emb


def composite(rgb_s, sigma, z):
    """Reference compositing (src/render.py:56-80): returns (rgb, depth, w)."""
    dists = torch.cat([z[..., 1:] - z[..., :-1],
                       torch.full_like(z[..., :1], 1e-3)], -1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10], -1),
        -1)[..., :-1]
    w = alpha * trans
    rgb = torch.sum(w[..., None] * rgb_s, -2)
    depth = torch.sum(w * z, -1) / (torch.sum(w, -1) + 1e-10)
    return rgb, depth, w


def ray_grid(height, width, focal):
    """Camera-frame pixel directions (src/ray_utils.py:26-28), on the CPU."""
    i, j = torch.meshgrid(torch.arange(height, dtype=torch.float32),
                          torch.arange(width, dtype=torch.float32),
                          indexing="ij")
    return torch.stack([(j - width * 0.5) / focal,
                        -(i - height * 0.5) / focal,
                        -torch.ones_like(i)], -1)


def rays_from_c2w(cam, c2w):
    """Rotate camera dirs into the world + broadcast origins
    (src/ray_utils.py:40-48)."""
    dirs = torch.sum(cam[..., None, :] * c2w[:3, :3], -1)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    origins = c2w[:3, 3].expand_as(dirs)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)


def sample_importance_z(z, weights, n_importance, u_jit):
    """Reference inverse-CDF importance sampling of new depths
    (src/ray_utils.py:105-139), with the per-bin jitter supplied by the
    caller.  Returns the UNION-SORTED depths (:142-144)."""
    eps = 1e-5
    w = weights + eps
    w = w / w.sum(dim=-1, keepdim=True)
    cdf = torch.cumsum(w, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)

    u = torch.linspace(0.0, 1.0, n_importance + 1, device=z.device)[:-1]
    u = u.expand(list(cdf.shape[:-1]) + [n_importance])
    u = u + u_jit / n_importance

    inds = torch.searchsorted(cdf.contiguous(), u.contiguous())
    below = torch.clamp_min(inds - 1, 0)
    above = torch.clamp_max(inds, cdf.shape[-1] - 1)
    inds_g = torch.stack([below, above], dim=-1)
    cdf_g = torch.gather(
        cdf.unsqueeze(-2).expand(*cdf.shape[:-1], n_importance, cdf.shape[-1]),
        dim=-1, index=inds_g)
    z_g = torch.gather(
        z.unsqueeze(-2).expand(*z.shape[:-1], n_importance, z.shape[-1]),
        dim=-1, index=torch.clamp_max(inds_g, z.shape[-1] - 1))
    denom = cdf_g[..., 1] - cdf_g[..., 0]
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g[..., 0]) / denom
    z_fine = z_g[..., 0] + t * (z_g[..., 1] - z_g[..., 0])
    z_all, _ = torch.sort(torch.cat([z, z_fine], dim=-1), dim=-1)
    return z_all


def export_init(model, emb):
    """Snapshot an init as {name: np.ndarray} (the repository script's
    ``export_init``; from any device)."""
    out = {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}
    if emb is not None:
        out["appearance_embeddings"] = emb.detach().cpu().numpy().copy()
    return out


def make_step_inputs(g, it, cfg, n_images, n_pixels):
    """Draw one step's randomness from the shared numpy stream (module-doc
    RNG protocol).  Returns (bs, img_idx, sel, jitter, u_jit|None)."""
    bs = 64 if it < cfg.warmup_iters else cfg.batch_size
    img_idx = int(g.integers(0, n_images))
    sel = g.choice(n_pixels, bs, replace=False)
    jitter = g.random((bs, cfg.num_samples), dtype=np.float32)
    u_jit = (g.random((bs, cfg.num_importance), dtype=np.float32)
             if cfg.num_importance > 0 else None)
    return bs, img_idx, sel, jitter, u_jit


def use_f32_highest() -> None:
    """Matmuls in full f32 (TF32 off), as the referee runs on the card: the
    entry points call this before ``train_reference``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_f32_highest(dev: torch.device) -> None:
    """On the card the referee runs in f32 with TF32 off: raise otherwise."""
    if dev.type != "cuda":
        return
    if (torch.backends.cuda.matmul.allow_tf32 is not False
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(
            "the reference trainer runs in f32 with TF32 off: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest') (now "
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            f"{torch.get_float32_matmul_precision()!r})")


def _upload(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``; to the card from pinned memory, queued
    behind the work already on the stream instead of waiting for it."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def _all_rays(c2ws, height, width, focal, dev):
    """(origins, dirs) of every pixel of every view, (N, H*W, 3) each,
    computed on the CPU view by view and moved to ``dev``."""
    cam = ray_grid(height, width, focal)
    ro_all, rd_all = [], []
    for c2w in c2ws:
        ro, rd = rays_from_c2w(cam, torch.tensor(np.asarray(c2w, np.float32)))
        ro_all.append(ro)
        rd_all.append(rd)
    return torch.stack(ro_all).to(dev), torch.stack(rd_all).to(dev)


def train_reference(cfg, images, c2ws, focal, iters, seed=0, log_every=100,
                    on_log=None, use_compile=False, init_out=None,
                    on_checkpoint=None, checkpoint_every=0, device="cuda"):
    """Train the reference semantics end to end on ``device``; returns
    (model, emb, mses).

    images: (N, H, W, 3) float32 in [0, 1]; c2ws: (N, 4, 4).
    use_compile: torch.compile the fwd+loss (identical math modulo fusion
        reassociation).
    init_out: optional dict populated with export_init() before training.
    on_checkpoint(it, model, emb, mses): periodic callback (partial reports).
    """
    dev = resolve_device(device)
    check_f32_highest(dev)
    g = np.random.default_rng(seed)
    n_images, height, width = images.shape[:3]

    model, emb = reference_init(cfg, n_images, seed)
    model = model.to(dev)
    emb = torch.nn.Parameter(emb.to(dev)) if emb is not None else None
    if init_out is not None:
        init_out.update(export_init(model, emb))
    params = list(model.parameters()) + ([emb] if emb is not None else [])
    opt = torch.optim.Adam(params, lr=cfg.learning_rate)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=cfg.scheduler_step_size, gamma=cfg.scheduler_gamma)

    imgs = torch.tensor(images).reshape(n_images, height * width, 3).to(dev)
    ro_all, rd_all = _all_rays(c2ws, height, width, focal, dev)

    def fwd(ro, rd, z, e, tgt, u_jit):
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        dirs = rd[:, None, :].expand(-1, z.shape[-1], -1)
        rgb_s, sigma = model(pts, dirs,
                             e.expand(-1, z.shape[-1], -1) if e is not None
                             else None)
        pred, _, w = composite(rgb_s, sigma, z)
        loss = torch.mean((pred - tgt) ** 2)
        if cfg.num_importance > 0:
            # hierarchical fine pass the reference declares (config.py:14):
            # importance resample from coarse weights, union sort, SAME model
            z_all = sample_importance_z(z.detach(), w.detach(),
                                        cfg.num_importance, u_jit)
            pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
            dirs = rd[:, None, :].expand(-1, z_all.shape[-1], -1)
            rgb_s, sigma = model(pts, dirs,
                                 e.expand(-1, z_all.shape[-1], -1)
                                 if e is not None else None)
            pred, _, _ = composite(rgb_s, sigma, z_all)
            # fine MSE + coarse auxiliary (danerf default coarse_loss_weight=1)
            loss_fine = torch.mean((pred - tgt) ** 2)
            return loss_fine + cfg.coarse_loss_weight * loss, loss_fine
        return loss, loss

    if use_compile:
        fwd = torch.compile(fwd, dynamic=True)

    # stratified bins (src/ray_utils.py:69-81), on the CPU, then moved
    t_lin = torch.linspace(0, 1, cfg.num_samples)
    z0 = cfg.near + t_lin * (cfg.far - cfg.near)
    mids = 0.5 * (z0[1:] + z0[:-1])
    upper = torch.cat([mids, z0[-1:]], -1).to(dev)
    lower = torch.cat([z0[:1], mids], -1).to(dev)
    mses, pending = [], []

    def flush():
        if pending:
            mses.extend(torch.stack(pending).tolist())
            pending.clear()

    for it in range(iters):
        # warmup batch 64 for the first 5 iters (src/train.py:26,56-58)
        bs, img_idx, sel, jitter, u_jit = make_step_inputs(
            g, it, cfg, n_images, height * width)
        sel_t = _upload(sel, dev)
        ro, rd = ro_all[img_idx][sel_t], rd_all[img_idx][sel_t]
        tgt = imgs[img_idx][sel_t]
        # stratified sampling with in-bin jitter; the jitter values come
        # from the shared numpy stream (module doc)
        z = lower + (upper - lower) * _upload(jitter, dev)

        e = emb[img_idx].expand(bs, 1, -1) if emb is not None else None
        loss, mse_fine = fwd(ro, rd, z, e, tgt,
                             _upload(u_jit, dev) if u_jit is not None else None)
        opt.zero_grad()
        loss.backward()
        opt.step()
        sched.step()
        pending.append(mse_fine.detach())
        logging = on_log is not None and (it + 1) % log_every == 0
        checkpointing = (on_checkpoint is not None and checkpoint_every
                         and (it + 1) % checkpoint_every == 0)
        if logging or checkpointing or len(pending) >= _FLUSH:
            flush()
        if logging:
            on_log(it + 1, -10.0 * np.log10(np.mean(mses[-log_every:])))
        if checkpointing:
            on_checkpoint(it + 1, model, emb, mses)
    flush()
    return model, emb, mses


@torch.no_grad()
def render_image_reference(model, cfg, c2w, height, width, focal, emb_row=None,
                           chunk=4096, n_importance=0):
    """Full-image no-jitter render (reference run.py:212-228 chunk loop), on
    the model's device; returns a (H, W, 3) numpy array.

    n_importance > 0 renders hierarchically: deterministic bin-center
    uniforms (u + 0.5/n, the perturb=False convention) invert the coarse
    CDF.
    """
    dev = next(model.parameters()).device
    cam = ray_grid(height, width, focal)
    ro, rd = rays_from_c2w(cam, torch.tensor(np.asarray(c2w, np.float32)))
    ro, rd = ro.to(dev), rd.to(dev)
    out = []
    t = torch.linspace(0, 1, cfg.num_samples)
    z_line = (cfg.near + t * (cfg.far - cfg.near)).to(dev)
    for s in range(0, ro.shape[0], chunk):
        o, d = ro[s:s + chunk], rd[s:s + chunk]
        z = z_line.expand(o.shape[0], -1)

        def field(zv):
            pts = o[:, None, :] + d[:, None, :] * zv[..., None]
            dirs = d[:, None, :].expand(-1, zv.shape[-1], -1)
            e = (emb_row.expand(o.shape[0], zv.shape[-1], -1)
                 if emb_row is not None else None)
            return model(pts, dirs, e)

        rgb_s, sigma = field(z)
        rgb, _, w = composite(rgb_s, sigma, z)
        if n_importance > 0:
            u_jit = torch.full((o.shape[0], n_importance), 0.5, device=dev)
            z_all = sample_importance_z(z, w, n_importance, u_jit)
            rgb_s, sigma = field(z_all)
            rgb, _, _ = composite(rgb_s, sigma, z_all)
        out.append(rgb)
    return torch.cat(out).reshape(height, width, 3).cpu().numpy()
