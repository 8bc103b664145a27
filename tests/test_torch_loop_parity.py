"""The training loop held against the JAX package's over a long horizon on
the CPU: 300 steps of the plain route (``use_pallas=False`` /
``use_kernels=False``) in f32 from the same init on the same draws.

The JAX side is ``make_train_step`` as ``train`` runs it: ``warmup_iters``
steps at ``warmup_batch_size`` rays, then ``batch_size`` rays a step.  Its
draws come from its own key chain (``trainer.py``: ``k_batch, k_render,
k_next = split(key, 3)``; ``sample_ray_batch`` splits ``k_batch`` into the
image and the pixels; ``render_rays`` splits ``k_render`` into the
stratified and the importance jitter), reproduced here and handed to the
port: the image and pixel indices to ``sample_ray_batch`` (``img_idx=``,
``pix_idx=``), the two jitters to ``compute_loss_and_grads`` (``draws=``).
The port's side is its own ``train_step`` (batch draw, loss and gradients,
the rate, Adam, StepLR) with those two functions fed the JAX draws, and
``train`` itself on the same feed, which must end where the step loop ends,
bit for bit.

StepLR's step size is 100, so the rate halves twice (after steps 100 and
200).  What a single-step test cannot see and this one can: a bias
correction, an epsilon or a rate off by one step, a warm-up that counts
differently; each moves every later step.

Tolerances (f32; the two packages sum in other orders, and Adam turns a
gradient element near 0 whose sign the rounding flips into a full step of
the rate the other way, so the trajectories part by a few percent and no
element-wise bound holds; a fault moves whole steps: a missing bias
correction triples the first step, a rate a step late doubles step 101):
- the rate before every step equals optax's ``exponential_decay(staircase=
  True)`` at the step's count to f32 rounding (``RATE_RTOL``);
- after steps 1, 100, 101, 200 and 300, over all leaves at once: the
  parameters' displacement from the init, the first and the second Adam
  moment, each as ||port - JAX|| / ||JAX|| below ``STATE_RTOL[what][step]``
  (measured 0.032 / 0.011 / 0.011 / 0.017 / 0.018 for the displacement,
  3e-5 / 0.011 / 0.011 / 0.032 / 0.061 for the first moment, 1.5e-6 /
  9e-4 / 9e-4 / 0.0038 / 0.0049 for the second; the bounds ~3x those);
- step 101's update (the first at the halved rate) within
  ``UPDATE_RTOL`` of JAX's, its norm within ``UPDATE_NORM`` (measured
  0.053 and 0.9988);
- the loss curve: the correlation of the two log-MSE curves above
  ``LOG_MSE_CORR`` (measured 0.99993) and every step's MSE within
  ``MSE_RTOL`` relative (measured 0.032).
"""

import jax
import numpy as np
import pytest
import torch

from danerf_tpu.config import NeRFConfig as JaxConfig
from danerf_tpu_torch.config import NeRFConfig

STEPS = 300
CHECKS = (1, 100, 101, 200, 300)
SMALL = dict(hidden_dim=48, num_layers=3, skip_connect_layers=(2,), appearance_dim=8,
             num_samples=8, num_importance=8, batch_size=128, warmup_batch_size=32,
             warmup_iters=5, scheduler_step_size=100, density_bias_init=0.5, use_bf16=False)
SCENE = dict(n_images=4, height=16, width=16, n_samples=32)
RATE_RTOL = 2 ** -23
STATE_RTOL = {"params": {1: 0.1, 100: 0.035, 101: 0.035, 200: 0.05, 300: 0.06},
              "mu": {1: 1e-4, 100: 0.035, 101: 0.035, 200: 0.1, 300: 0.2},
              "nu": {1: 5e-6, 100: 3e-3, 101: 3e-3, 200: 0.012, 300: 0.015}}
UPDATE_RTOL, UPDATE_NORM = 0.15, 0.02
LOG_MSE_CORR = 0.9995
MSE_RTOL = 0.1


def _jax_draws(key, n_images, height, width, batch_size, cfg):
    """The draws of one JAX training step from its state's key, and the
    next key (``make_train_step``'s ``one_step``)."""
    k_batch, k_render, k_next = jax.random.split(key, 3)
    k_img, k_pix = jax.random.split(k_batch)
    img = jax.random.randint(k_img, (), 0, n_images)
    pix = jax.random.randint(k_pix, (batch_size,), 0, height * width)
    k_strat, k_imp = jax.random.split(k_render)
    u_strat = jax.random.uniform(k_strat, (batch_size, cfg.num_samples))
    u_imp = jax.random.uniform(k_imp, (batch_size, cfg.num_importance))
    return (img, pix, u_strat, u_imp), k_next


def _leaves(tree) -> list:
    return [np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """This file's runs on two intra-op threads (``train`` is held bit for
    bit against the step loop, so both need one count); the process's
    count is restored after the file."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def runs():
    """The JAX run and the port's step loop, with their snapshots."""
    from jax.flatten_util import ravel_pytree

    from danerf_tpu.data.synthetic import make_synthetic_scene
    from danerf_tpu.train.trainer import create_train_state, lr_schedule, make_train_step
    from danerf_tpu_torch.data.dataset import RayDataset
    from danerf_tpu_torch.kernels.fused_mlp import params_from_jax_module
    from danerf_tpu_torch.train.trainer import make_optimizer, train_step
    from danerf_tpu_torch.utils.convert import params_to_jax

    jcfg = JaxConfig(**SMALL, use_pallas=False)
    cfg = NeRFConfig(**SMALL, use_kernels=False)
    scene = make_synthetic_scene("train", **SCENE)
    h, w, focal, n = scene.height, scene.width, scene.focal, scene.n_images
    jpool = scene.device_arrays()
    state = create_train_state(jax.random.key(0), jcfg, n)
    init = jax.tree.map(np.asarray, state.params)
    steps = {bs: make_train_step(jcfg, h, w, focal, batch_size=bs)
             for bs in (jcfg.warmup_batch_size, jcfg.batch_size)}
    draw = {bs: jax.jit(lambda k, bs=bs: _jax_draws(k, n, h, w, bs, jcfg))
            for bs in steps}
    unravel = ravel_pytree(state.params)[1]
    schedule = lr_schedule(jcfg)

    sizes = [jcfg.warmup_batch_size if i < jcfg.warmup_iters else jcfg.batch_size
             for i in range(STEPS)]
    jax_run = {"mse": [], "rate": [], "snap": {}}
    feed, key = [], state.key
    for i, bs in enumerate(sizes):
        drawn, key = draw[bs](key)
        feed.append(tuple(torch.tensor(np.asarray(x)) for x in drawn))
        jax_run["rate"].append(float(schedule(int(state.opt_state[0].count))))
        state, metrics = steps[bs](state, jpool)
        jax_run["mse"].append(float(metrics["mse"]))
        if i + 1 in CHECKS:
            adam = state.opt_state[0]
            jax_run["snap"][i + 1] = {
                "params": jax.tree.map(np.asarray, state.params),
                "mu": jax.tree.map(np.asarray, unravel(adam.mu)),
                "nu": jax.tree.map(np.asarray, unravel(adam.nu)),
                "count": int(adam.count)}

    ds = RayDataset(images=scene.images, alphas=scene.alphas, c2ws=scene.c2ws, focal=focal,
                    near=scene.near, far=scene.far)
    model = params_from_jax_module(init["model"], cfg, device="cpu")
    table = torch.nn.Parameter(torch.tensor(init["appearance"]))
    names = [name for name, _ in model.named_parameters()]
    params = list(model.parameters()) + [table]
    optimizer, scheduler = make_optimizer(cfg, params)
    pool = ds.device_arrays(device="cpu")

    def tree(values):
        return {"model": params_to_jax(dict(zip(names, values[:-1]))),
                "appearance": values[-1].detach().numpy()}

    port = {"mse": [], "rate": [], "snap": {}}
    with fed(feed):
        for i, bs in enumerate(sizes):
            port["rate"].append(optimizer.param_groups[0]["lr"])
            metrics = train_step(model, table, optimizer, scheduler, pool, cfg, h, w, focal,
                                 bs, None)
            port["mse"].append(float(metrics["mse"]))
            if i + 1 in CHECKS:
                st = [optimizer.state[p] for p in params]
                port["snap"][i + 1] = {
                    "params": tree([p.detach().clone() for p in params]),
                    "mu": tree([s["exp_avg"].clone() for s in st]),
                    "nu": tree([s["exp_avg_sq"].clone() for s in st]),
                    "count": int(st[0]["step"])}
    return {"jax": jax_run, "port": port, "feed": feed, "ds": ds, "cfg": cfg, "init": init}


class fed:
    """``sample_ray_batch`` and ``compute_loss_and_grads`` of the port's
    trainer, fed the JAX draws in order while the block runs: each batch
    draw takes the next step's image and pixels (its size must be the
    step's), each loss the next step's jitters."""

    def __init__(self, feed):
        self.feed = feed

    def __enter__(self):
        from danerf_tpu_torch.train import trainer

        self.trainer = trainer
        self.saved = trainer.sample_ray_batch, trainer.compute_loss_and_grads
        sample, loss = self.saved
        batches, jitters = iter(self.feed), iter(self.feed)

        def sample_fed(pool, cfg, height, width, focal, batch_size=None, generator=None):
            img, pix, _, _ = next(batches)
            assert len(pix) == (batch_size or cfg.batch_size)
            return sample(pool, cfg, height, width, focal, batch_size, img_idx=img,
                          pix_idx=pix)

        def loss_fed(model, table, cfg, batch, generator=None, draws=None):
            _, _, u_strat, u_imp = next(jitters)
            return loss(model, table, cfg, batch, draws=(u_strat, u_imp))

        trainer.sample_ray_batch, trainer.compute_loss_and_grads = sample_fed, loss_fed
        return self

    def __exit__(self, *exc):
        self.trainer.sample_ray_batch, self.trainer.compute_loss_and_grads = self.saved


def test_the_rate_is_optax_staircase_at_every_step(runs):
    jax_rate, port_rate = np.asarray(runs["jax"]["rate"]), np.asarray(runs["port"]["rate"])
    np.testing.assert_allclose(port_rate, jax_rate, rtol=RATE_RTOL)
    lr = runs["cfg"].learning_rate
    assert port_rate[0] == lr and port_rate[100] == pytest.approx(lr / 2, rel=RATE_RTOL)
    assert port_rate[99] == lr and port_rate[200] == pytest.approx(lr / 4, rel=RATE_RTOL)


def _flat(leaves) -> np.ndarray:
    return np.concatenate([x.ravel() for x in leaves])


@pytest.mark.parametrize("step", CHECKS)
@pytest.mark.parametrize("what", ["params", "mu", "nu"])
def test_state_matches_jax(runs, step, what):
    """The parameters' displacement from the init and both Adam moments
    after ``step`` steps, over every leaf in JAX's tree order, and Adam's
    count."""
    want, got = runs["jax"]["snap"][step], runs["port"]["snap"][step]
    assert got["count"] == want["count"] == step
    a, b = _flat(_leaves(got[what])), _flat(_leaves(want[what]))
    if what == "params":
        init = _flat(_leaves(runs["init"]))
        a, b = a - init, b - init
    err = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert err < STATE_RTOL[what][step], f"{what} after {step}: {err}"


def test_the_first_step_at_the_halved_rate_matches_jax(runs):
    """Step 101, the first after StepLR's first boundary: a rate a step
    early or late doubles or halves it."""
    def update(run):
        return (_flat(_leaves(run["snap"][101]["params"]))
                - _flat(_leaves(run["snap"][100]["params"])))

    got, want = update(runs["port"]), update(runs["jax"])
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < UPDATE_RTOL
    assert abs(np.linalg.norm(got) / np.linalg.norm(want) - 1.0) < UPDATE_NORM


def test_the_loss_curves_agree(runs):
    j, p = np.asarray(runs["jax"]["mse"]), np.asarray(runs["port"]["mse"])
    assert len(j) == len(p) == STEPS
    corr = np.corrcoef(np.log(j), np.log(p))[0, 1]
    assert corr > LOG_MSE_CORR, corr
    np.testing.assert_allclose(p, j, rtol=MSE_RTOL)
    # it trains: the last 50 steps' MSE well below the first 50's
    assert p[-50:].mean() < 0.5 * p[:50].mean()


def test_train_runs_the_step_loop(runs, tmp_path):
    """``train`` itself (warm-up steps, chunks of 10 never across a
    checkpoint, StepLR) on the same feed ends where the step loop ended,
    bit for bit: parameters, moments and Adam's count."""
    from danerf_tpu_torch.train.trainer import train

    with fed(runs["feed"]):
        model, table, log = train(runs["cfg"], runs["ds"], save_dir=str(tmp_path),
                                  num_iterations=STEPS, checkpoint_every=100, eval_every=0,
                                  device="cpu", progress=False, init_params=runs["init"])
    ckpt = torch.load(tmp_path / "checkpoint_final.pt", weights_only=False)
    assert [r["step"] for r in log.history] == list(range(1, STEPS + 1))
    np.testing.assert_array_equal([r["mse"] for r in log.history],
                                  np.float32(runs["port"]["mse"]))
    names = [n for n, _ in model.named_parameters()]
    from danerf_tpu_torch.utils.convert import params_to_jax

    got = {"model": params_to_jax(dict(model.named_parameters())),
           "appearance": table.detach().numpy()}
    for a, b in zip(_leaves(got), _leaves(runs["port"]["snap"][STEPS]["params"]), strict=True):
        np.testing.assert_array_equal(a, b)
    opt = ckpt["optimizer_state_dict"]["state"]
    assert int(opt[0]["step"]) == STEPS and len(opt) == len(names) + 1
