"""The port reads the JAX package's checkpoint directories without JAX.

Held on the CPU against the JAX side:

- (a) ``utils/zstd.py`` against ``zstandard`` at levels -5, 1, 3 and 19 on
  f32 weights, zeros, text, random bytes and a multi-block input above
  128 KiB; frames with a checksum, without a content size, concatenated,
  behind a skippable frame; a short hypothesis run;
- (b) ``utils/ocdbt.py``'s ``list()`` and ``read()`` against tensorstore's
  ``ocdbt`` kvstore, every key, bytes equal: an orbax checkpoint, a B+tree
  of several levels and versions over many data files, one uncompressed;
- (c) ``read_jax_checkpoint`` against the JAX ``restore_checkpoint``,
  every leaf bit for bit: the small config with appearance, without, with
  ``use_time``, at 11 layers, and orbax without OCDBT; the committed
  full-width fixture against its digests, and within its size budget;
- (d) ``restore_training_state`` from the directory against the same from
  ``orbax_to_pt.py``'s ``.pt``, every tensor equal (StepLR also across
  several decays), then one resumed CPU step from each, equal;
- (e) ``render_rays`` of ``load_model(dir)`` against the JAX
  ``render_rays`` (rtol 1e-5 + atol 1e-5, as ``test_torch_orbax.py``);
- (f) the CLI: ``render``, ``spiral`` and ``eval --checkpoint DIR`` (the
  same files and numbers as from the converted ``.pt``), the default
  ``checkpoints_<scene>`` lookup and its rule, ``train --resume`` in a save
  directory of JAX checkpoints;
- (g) the refusals, each naming its cause.

Small config of ``test_torch_orbax.py`` (hidden 32, 2 layers, appearance
8, 8 + 4 samples, f32), 3 JAX training steps on a procedural scene of 3
images at 12x12.
"""

import dataclasses
import hashlib
import io
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_orbax import SMALL, _jax_checkpoint, _port_cfg
from test_torch_train_loop import _one_thread

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import orbax_to_pt  # noqa: E402

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_torch")
FIXTURE = os.path.join(DATA, "jax_run", "checkpoint_000003")


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """``_jax_checkpoint`` of each config once a module: (cfg, dataset,
    state, path); a test that changes the directory copies it first."""
    cache = {}

    def get(**over):
        key = repr(sorted(over.items()))
        if key not in cache:
            cache[key] = _jax_checkpoint(tmp_path_factory.mktemp("jax"), **over)
        return cache[key]

    return get


def _leaves(tree, prefix=()):
    """{orbax name: array} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _leaves(sub, prefix + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _leaves(sub, prefix + (str(i),)).items()}
    return {".".join(map(str, prefix)): np.asarray(tree)}


def _jax_leaves(tree):
    """{orbax name: numpy array} of a JAX tree (typed keys as raw data)."""
    out = {}
    for p, x in jax.tree_util.tree_leaves_with_path(tree):
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key):
            x = jax.random.key_data(x)
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", None))))
                        for k in p)
        out[name] = np.asarray(x)
    return out


def _assert_bit_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (k, g.dtype, w.dtype, g.shape, w.shape)
        assert g.tobytes() == w.tobytes(), k


# ---------------------------------------------------------------- (a) zstd

def _inputs():
    rng = np.random.default_rng(0)
    text = open(os.path.join(os.path.dirname(DATA), "..", "README.md"), "rb").read()
    return {"f32_weights": (rng.normal(size=20000) * 0.05).astype(np.float32).tobytes(),
            "zeros": bytes(70000),
            "text": text[:60000],
            "random": rng.bytes(40000),
            "multi_block": (rng.normal(size=30000) * 0.02).astype(np.float32).tobytes()
            + bytes(20000) + text[:30000]}


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("kind", ["f32_weights", "zeros", "text", "random", "multi_block"])
def test_zstd_matches_zstandard(level, kind):
    from danerf_tpu_torch.utils import zstd

    data = _inputs()[kind]
    frame = zstandard.ZstdCompressor(level=level).compress(data)
    assert zstd.decompress(frame) == data
    if kind == "multi_block":
        assert len(data) > 128 * 1024


def test_zstd_frame_forms():
    """A checksum (XXH64), no content size (streamed), two frames in a row,
    a skippable frame first; several buffers at once."""
    from danerf_tpu_torch.utils import zstd

    data = _inputs()["multi_block"]
    with_sum = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    assert with_sum[4] & 4 and zstd.decompress(with_sum) == data
    buf = io.BytesIO()
    with zstandard.ZstdCompressor(level=1, write_content_size=False).stream_writer(
            buf, closefd=False) as w:
        w.write(data)
    streamed = buf.getvalue()
    assert not streamed[4] & 0xC0 and zstd.decompress(streamed) == data
    skip = (0x184D2A53).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
    small = zstandard.ZstdCompressor(level=19).compress(b"tiny")
    assert zstd.decompress(skip + small + with_sum) == b"tiny" + data
    bufs = [with_sum, streamed, small, zstandard.ZstdCompressor().compress(b"")]
    assert zstd.decompress_many(bufs) == [data, data, b"tiny", b""]
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999


@settings(max_examples=30, deadline=5000, database=None)
@given(st.lists(st.binary(max_size=300), max_size=12), st.integers(0, 30),
       st.sampled_from([-5, 1, 3, 9, 19]), st.booleans())
def test_zstd_hypothesis(parts, repeat, level, checksum):
    from danerf_tpu_torch.utils import zstd

    data = b"".join(parts) * (repeat + 1)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


# ---------------------------------------------------------------- (b) OCDBT

def _kvstore_items(root):
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _tree_store(root, compression):
    """A B+tree of several levels and versions over many data files."""
    import tensorstore as ts

    config = {"max_decoded_node_bytes": 200, "max_inline_value_bytes": 8}
    if compression is None:
        config["compression"] = None
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/", "config": config}
                         ).result()
    rng = np.random.default_rng(0)
    for v in range(3):
        with ts.Transaction() as txn:
            for _ in range(60):
                key = bytes(rng.integers(97, 100, int(rng.integers(1, 10)), dtype=np.uint8))
                kv.with_transaction(txn)[key.decode()] = rng.bytes(int(rng.integers(0, 40)))
    del kv["a"]


@pytest.mark.parametrize("which", ["orbax", "tree_zstd", "tree_uncompressed"])
def test_ocdbt_matches_tensorstore(tmp_path, jax_ckpt, which):
    from danerf_tpu_torch.utils.ocdbt import OcdbtStore

    if which == "orbax":
        _, _, _, path = jax_ckpt()
        root = os.path.join(path, "state")
    else:
        root = str(tmp_path / "kv")
        _tree_store(root, {"id": "zstd"} if which == "tree_zstd" else None)
    want = _kvstore_items(root)
    store = OcdbtStore(root)
    assert store.list() == sorted(want) and len(want) > 30
    assert {k: store.read(k) for k in store.list()} == want
    if which != "orbax":
        assert store.config["root_height"] > 1
    with pytest.raises(KeyError):
        store.read("no such key")


# ---------------------------------------------------------------- (c) read


@pytest.mark.parametrize("over", [{}, {"use_appearance": False}, {"use_time": True},
                                  {"num_layers": 11, "skip_connect_layers": (4, 9)}],
                         ids=["appearance", "no_appearance", "use_time", "layers11"])
def test_read_matches_jax_restore(jax_ckpt, over):
    from danerf_tpu.train.trainer import create_train_state
    from danerf_tpu.utils.checkpoint import restore_checkpoint
    from danerf_tpu_torch.utils.checkpoint import read_jax_checkpoint

    cfg, ds, state, path = jax_ckpt(**over)
    restored, meta = restore_checkpoint(path, create_train_state(jax.random.key(1), cfg,
                                                                 ds.n_images))
    tree, got_meta = read_jax_checkpoint(path)
    assert got_meta == meta and meta["backend"] == "orbax"
    want = _jax_leaves(restored)
    _assert_bit_equal(_leaves(tree), want)
    assert isinstance(tree["params"]["model"]["trunk"], list)
    assert len(tree["params"]["model"]["trunk"]) == cfg.num_layers
    assert any(np.abs(v).max() > 0 for k, v in want.items() if k.endswith(".mu"))


def test_read_orbax_without_ocdbt(tmp_path):
    """orbax with ``use_ocdbt=False``: zarr arrays in plain directories."""
    import orbax.checkpoint as ocp

    from danerf_tpu_torch.utils.checkpoint import read_jax_checkpoint

    rng = np.random.default_rng(0)
    tree = {"params": {"model": {"trunk": [{"w": rng.normal(size=(5, 7)).astype(np.float32)},
                                           {"w": np.arange(6, dtype=np.int32)}]}},
            "key": np.array([1, 2], np.uint32), "step": np.array(4, np.int32)}
    path = tmp_path / "checkpoint_000004"
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        str(path / "state"), args=ocp.args.StandardSave(tree))
    (path / "meta.json").write_text(json.dumps({"step": 4, "backend": "orbax"}))
    assert not (path / "state" / "manifest.ocdbt").exists()
    got, _ = read_jax_checkpoint(str(path))
    _assert_bit_equal(_leaves(got), _leaves(tree))


def test_fixture_matches_its_digests():
    """The committed full-width checkpoint, every leaf against the digest
    the JAX ``restore_checkpoint`` gave (``write_jax_checkpoint.py``)."""
    from danerf_tpu_torch.utils.checkpoint import read_jax_checkpoint

    with open(os.path.join(DATA, "jax_checkpoint_digests.json")) as f:
        digests = json.load(f)
    tree, meta = read_jax_checkpoint(FIXTURE)
    assert meta == digests["meta"]
    leaves = _leaves(tree)
    assert sorted(leaves) == sorted(digests["leaves"])
    for name, d in digests["leaves"].items():
        x = leaves[name]
        assert (x.dtype.name, list(x.shape)) == (d["dtype"], d["shape"]), name
        assert hashlib.sha256(x.tobytes()).hexdigest() == d["sha256"], name
    assert leaves["params.model.trunk.1.w"].shape == (256, 256)
    assert leaves["opt_state.0.mu"].shape == (534436,)


# the committed jax_run/ fixture's own budget, apart from the one of the
# top of data_torch/: its Adam moments are non-zero, so they do not compress
JAX_RUN_BUDGET = 6_500_000


def test_fixture_within_its_size_budget():
    """Every file under ``jax_run/``, so that a larger re-run of
    ``write_jax_checkpoint.py`` cannot grow the repository unseen."""
    root = os.path.join(DATA, "jax_run")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    assert 1_000_000 < size < JAX_RUN_BUDGET, size


# ---------------------------------------------------------------- (d) resume

def _restored(src, tcfg, n_images, seed=1):
    from danerf_tpu_torch.train.trainer import init_model, make_optimizer
    from danerf_tpu_torch.utils.checkpoint import restore_training_state

    model, table = init_model(tcfg, n_images, seed, "cpu")
    params = list(model.parameters()) + ([table] if table is not None else [])
    opt, sched = make_optimizer(tcfg, params)
    it = restore_training_state(src, model, table, opt, sched)
    return it, model, table, opt, sched


@pytest.mark.parametrize("over", [{}, {"num_layers": 11, "skip_connect_layers": (4, 9)},
                                  {"use_appearance": False},
                                  {"scheduler_step_size": 1, "scheduler_gamma": 0.1}],
                         ids=["small", "layers11", "no_appearance", "decayed"])
def test_restore_matches_orbax_to_pt(tmp_path, jax_ckpt, over):
    from danerf_tpu_torch.train.trainer import train_step

    cfg, ds, state, path = jax_ckpt(**over)
    pt = orbax_to_pt.convert(path, str(tmp_path / "c.pt"), cfg, ds.n_images)
    tcfg = _port_cfg(cfg)
    a = _restored(pt, tcfg, ds.n_images)
    b = _restored(path, tcfg, ds.n_images)
    assert a[0] == b[0] == 3
    for k, v in a[1].state_dict().items():
        assert torch.equal(v, b[1].state_dict()[k]), k
    assert (a[2] is None and b[2] is None) or torch.equal(a[2], b[2])
    sa, sb = a[3].state_dict(), b[3].state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k]), (i, k)
    assert float(sb["state"][0]["exp_avg_sq"].abs().max()) > 0
    assert a[4].state_dict() == b[4].state_dict()
    # one resumed step from each, equal
    from danerf_tpu_torch.data.synthetic import make_synthetic_scene

    tds = make_synthetic_scene(n_images=3, height=12, width=12, n_samples=16)
    steps = []
    with _one_thread():          # the two runs compared bit for bit (``_one_thread``'s reason)
        for it, model, table, opt, sched in (a, b):
            m = train_step(model, table, opt, sched, tds.device_arrays(device="cpu"), tcfg,
                           tds.height, tds.width, tds.focal, 16, torch.Generator().manual_seed(0))
            steps.append((m, model.state_dict(), opt.state_dict()))
    (ma, pa, oa), (mb, pb, ob) = steps
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    assert np.isfinite(float(ma["loss"]))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(oa["state"][i]["exp_avg"], ob["state"][i]["exp_avg"])
               for i in oa["state"])
    assert float(oa["state"][0]["step"]) == 4


# ---------------------------------------------------------------- (e) render


@pytest.mark.parametrize("over", [{}, {"use_time": True}], ids=["appearance", "use_time"])
def test_render_rays_of_a_directory_matches_jax(jax_ckpt, over):
    import jax.numpy as jnp

    from danerf_tpu.render.renderer import render_rays as j_render_rays
    from danerf_tpu_torch.render.renderer import render_rays
    from danerf_tpu_torch.utils.checkpoint import load_model

    cfg, ds, state, path = jax_ckpt(**over)
    model, table, meta, tcfg = load_model(path, _port_cfg(cfg), "cpu")
    assert meta["iteration"] == 3 and np.isfinite(meta["loss"]) and tcfg.use_appearance
    params = jax.tree.map(np.asarray, state.params)
    np.testing.assert_array_equal(table.numpy(), params["appearance"])
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(20, 3)) * 0.1 + [0.0, 0.0, 4.0]).astype(np.float32)
    d = (rng.normal(size=(20, 3)) * 0.2 + [0.0, 0.0, -1.0]).astype(np.float32)
    emb = rng.normal(size=(20, 8)).astype(np.float32)
    t = np.full((20, 1), 0.3, np.float32) if cfg.use_time else None
    want = j_render_rays(params["model"], cfg, jax.random.key(0), jnp.asarray(o),
                         jnp.asarray(d), jnp.asarray(emb),
                         t=None if t is None else jnp.asarray(t), perturb=False)
    with torch.no_grad():
        got = render_rays(model, tcfg, torch.tensor(o), torch.tensor(d), torch.tensor(emb),
                          t=None if t is None else torch.tensor(t), perturb=False)
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------- (f) the CLI

def _small_cfg(monkeypatch, tcfg):
    from danerf_tpu_torch import config as config_mod

    small = {k: getattr(tcfg, k) for k in SMALL}
    cls = dataclasses.make_dataclass(
        "Small", [(k, type(v), dataclasses.field(default=v)) for k, v in small.items()],
        bases=(config_mod.NeRFConfig,), frozen=True)
    monkeypatch.setattr(config_mod, "NeRFConfig", cls)


def test_cli_render_spiral_eval_take_a_directory(tmp_path, monkeypatch, capsys, jax_ckpt):
    """--checkpoint DIR gives the same frames and scores as the .pt that
    orbax_to_pt.py converts it to."""
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu_torch.cli.main import main

    cfg, ds, _, path = jax_ckpt()
    pt = orbax_to_pt.convert(path, str(tmp_path / "c.pt"), cfg, ds.n_images)
    _small_cfg(monkeypatch, _port_cfg(cfg))
    save_blender_scene(ds, str(tmp_path / "data" / "tiny"), split="train")
    common = ["--dataset_path", str(tmp_path / "data"), "--scene", "tiny", "--device", "cpu"]
    out = {}
    for name, ckpt in (("dir", path), ("pt", pt)):
        render = main(["render", "--checkpoint", ckpt, "--output_dir", str(tmp_path / name),
                       "--frames", "2", "--width", "8", "--height", "6", "--quality",
                       "preview", *common])
        spiral = main(["spiral", "--checkpoint", ckpt, "--output_dir",
                       str(tmp_path / f"sp_{name}"), "--frames", "2", "--width", "8",
                       "--height", "6", *common])
        ev = main(["eval", "--checkpoint", ckpt, "--split", "train", "--max_views", "2",
                   *common])
        out[name] = ([open(p, "rb").read() for p in render], spiral, ev)
    text = capsys.readouterr().out
    assert "Imported JAX checkpoint (iteration 3)" in text
    assert out["dir"][0] == out["pt"][0] and len(out["dir"][0]) == 2
    frames = sorted(f for f in os.listdir(tmp_path / "sp_dir") if f.startswith("frame_"))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    for f in frames:
        assert (tmp_path / "sp_dir" / f).read_bytes() == (tmp_path / "sp_pt" / f).read_bytes()
    assert out["dir"][2]["psnr"] == out["pt"][2]["psnr"] and out["dir"][2]["n_views"] == 2


def test_cli_render_finds_the_latest_directory(tmp_path, monkeypatch, capsys, jax_ckpt):
    """Without --checkpoint, render takes the latest of checkpoints_<scene>:
    a JAX directory of a higher step than a .pt."""
    from danerf_tpu_torch.cli.main import main

    cfg, ds, _, path = jax_ckpt()
    _small_cfg(monkeypatch, _port_cfg(cfg))
    save = tmp_path / "work" / "checkpoints_tiny"
    save.mkdir(parents=True)
    shutil.copytree(path, save / "checkpoint_000003")
    orbax_to_pt.convert(path, str(save / "checkpoint_000002.pt"), cfg, ds.n_images)
    monkeypatch.chdir(tmp_path / "work")
    written = main(["render", "--scene", "tiny", "--output_dir", str(tmp_path / "f"),
                    "--frames", "1", "--width", "6", "--height", "5", "--quality", "preview",
                    "--device", "cpu", "--dataset_path", str(tmp_path / "none")])
    assert len(written) == 1 and os.path.exists(written[0])
    text = capsys.readouterr().out
    assert f"Using checkpoint: {os.path.join('checkpoints_tiny', 'checkpoint_000003')}" in text


@pytest.mark.parametrize("layout,want", [
    (["checkpoint_000005.pt", "checkpoint_000007/"], "checkpoint_000007"),
    (["checkpoint_000007.pt", "checkpoint_000007/"], "checkpoint_000007.pt"),
    (["checkpoint_final/", "checkpoint_000900.pt"], "checkpoint_final"),
    (["checkpoint_final/", "checkpoint_final.pt"], "checkpoint_final.pt"),
    (["checkpoint_000009/-", "checkpoint_000002.pt"], "checkpoint_000002.pt"),
    (["checkpoint_final/-", "checkpoint_000004/"], "checkpoint_000004"),
    (["checkpoint_000003/-"], None)],
    ids=["dir_step", "tie_pt", "final_dir", "final_tie_pt", "dir_without_meta",
         "final_without_meta", "none"])
def test_latest_checkpoint_rule(tmp_path, layout, want):
    """A checkpoint_final of either kind beats any step, else the highest
    step; on a tie the .pt; a directory only with its meta.json."""
    from danerf_tpu_torch.utils.checkpoint import latest_checkpoint

    for name in layout:
        if name.endswith(".pt"):
            (tmp_path / name).write_bytes(b"")
        else:
            d = tmp_path / name.rstrip("/-").rstrip("/")
            d.mkdir()
            if not name.endswith("-"):
                (d / "meta.json").write_text("{}")
    got = latest_checkpoint(str(tmp_path))
    assert got == (None if want is None else str(tmp_path / want))


def test_cli_train_resumes_a_jax_directory(tmp_path, monkeypatch, jax_ckpt):
    """train --resume in a save directory of JAX checkpoints: it continues
    from step 3 (Adam's count too), not from 0."""
    from danerf_tpu.data.blender import save_blender_scene
    from danerf_tpu_torch.cli.main import main

    cfg, ds, _, path = jax_ckpt()
    save = tmp_path / "run"
    save.mkdir()
    shutil.copytree(path, save / "checkpoint_000003")
    save_blender_scene(ds, str(tmp_path / "data" / "tiny"), split="train")
    _small_cfg(monkeypatch, _port_cfg(cfg))
    main(["train", "--dataset_path", str(tmp_path / "data"), "--scene", "tiny", "--save_dir",
          str(save), "--iters", "5", "--resume", "--checkpoint_every", "0", "--device", "cpu"])
    final = torch.load(str(save / "checkpoint_final.pt"), map_location="cpu", weights_only=False)
    assert final["iteration"] == 5
    assert all(float(s["step"]) == 5 for s in final["optimizer_state_dict"]["state"].values())
    rows = [json.loads(line) for line in open(save / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [4, 5] and np.isfinite(rows[-1]["loss"])


# ---------------------------------------------------------------- (g) refusals

def _zarray(**over):
    meta = {"chunks": [4], "compressor": {"id": "zstd", "level": 1}, "dimension_separator": ".",
            "dtype": "<f4", "fill_value": None, "filters": None, "order": "C", "shape": [6],
            "zarr_format": 2}
    meta.update(over)
    return json.dumps(meta)


@pytest.mark.parametrize("case,match", [
    ("zarr3", "zarr v3"), ("compressor", "compressor 'blosc'"), ("filters", "filters"),
    ("order", "order 'F'"), ("big_endian", "dtype '>f4'"), ("short_chunk", "truncated"),
    ("short_raw_chunk", "holds 8 bytes")])
def test_zarr_refusals(tmp_path, case, match):
    from danerf_tpu_torch.utils import zarr

    a = tmp_path / "a"
    a.mkdir()
    over = {"zarr3": {}, "compressor": {"compressor": {"id": "blosc"}},
            "filters": {"filters": [{"id": "delta", "dtype": "<f4"}]}, "order": {"order": "F"},
            "big_endian": {"dtype": ">f4"}, "short_chunk": {},
            "short_raw_chunk": {"compressor": None}}[case]
    (a / ".zarray").write_text(_zarray(**over))
    chunk = np.arange(4, dtype=np.float32).tobytes()
    if case == "zarr3":
        (a / "zarr.json").write_text("{}")
    if case == "short_raw_chunk":
        chunk = chunk[:8]
    elif case != "zarr3":
        chunk = zstandard.ZstdCompressor().compress(chunk)
        if case == "short_chunk":
            chunk = chunk[:-3]
    (a / "0").write_bytes(chunk)
    with pytest.raises(ValueError, match=match):
        zarr.read_arrays(zarr.DirectoryStore(str(tmp_path)), ["a"])


def test_zarr_edge_chunks_fill_and_separators(tmp_path):
    """Edge chunks, a missing chunk filled with fill_value, both separators,
    raw and zstd chunks, several dtypes: against tensorstore's zarr driver."""
    import tensorstore as ts

    from danerf_tpu_torch.utils import zarr

    rng = np.random.default_rng(0)
    cases = {"f": ("<f4", (7, 5), (3, 2), ".", {"id": "zstd", "level": 3}, 1.5),
             "i": ("<i4", (9,), (4,), "/", None, -3),
             "u": ("<u4", (2, 3, 4), (2, 2, 3), "/", {"id": "zstd", "level": 1}, 0),
             "d": ("<f8", (), (), ".", None, 0.0),
             "b": ("|u1", (10, 3), (4, 3), ".", None, 7)}
    want = {}
    for name, (dtype, shape, chunks, sep, comp, fill) in cases.items():
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{tmp_path}/{name}/",
                       "metadata": {"dtype": dtype, "shape": list(shape), "chunks": list(chunks),
                                    "dimension_separator": sep, "compressor": comp,
                                    "fill_value": fill}},
                      create=True).result()
        x = (rng.normal(size=shape) * 100).astype(np.dtype(dtype))
        # all but the first chunk where the array has more than one
        region = tuple(slice(c if c < n else 0, None) for c, n in zip(chunks, shape))
        arr[region] = x[region]
        want[name] = arr.read().result()
        first = sep.join("0" for _ in shape) or "0"
        assert os.path.exists(tmp_path / name / first) == (name in ("d",))
    got = zarr.read_arrays(zarr.DirectoryStore(str(tmp_path)), list(cases))
    _assert_bit_equal(got, want)


def test_checkpoint_refusals(tmp_path):
    """No meta.json; use_zarr3; an unknown key type; a dictionary ID; a
    truncated OCDBT node; a params tree without the model."""
    import orbax.checkpoint as ocp

    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.utils import zstd
    from danerf_tpu_torch.utils.checkpoint import load_model, read_jax_checkpoint
    from danerf_tpu_torch.utils.ocdbt import OcdbtStore

    with pytest.raises(ValueError, match="no meta.json"):
        read_jax_checkpoint(str(tmp_path))
    ck = tmp_path / "ck"
    shutil.copytree(FIXTURE, ck)
    md = json.loads((ck / "state" / "_METADATA").read_text())
    (ck / "state" / "_METADATA").write_text(json.dumps({**md, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3"):
        read_jax_checkpoint(str(ck))
    first = next(iter(md["tree_metadata"]))
    md["tree_metadata"][first]["key_metadata"][0]["key_type"] = 7
    (ck / "state" / "_METADATA").write_text(json.dumps(md))
    with pytest.raises(ValueError, match="key_type 7"):
        read_jax_checkpoint(str(ck))
    frame = zstandard.ZstdCompressor().compress(b"0123456789" * 50)
    assert frame[4] & 0x23 == 0x20          # single segment, no dictionary ID
    with_id = frame[:4] + bytes([frame[4] | 1, 7]) + frame[5:]
    assert zstd.decompress(frame) == b"0123456789" * 50
    with pytest.raises(ValueError, match="dictionary 7"):
        zstd.decompress(with_id)
    node = next(p for p in (ck / "state" / "d").iterdir())
    node.write_bytes(node.read_bytes()[:-40])
    with pytest.raises(ValueError, match="truncated"):
        OcdbtStore(str(ck / "state"))
    bare = tmp_path / "bare"
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        str(bare / "state"), args=ocp.args.StandardSave({"step": np.array(3, np.int32)}))
    (bare / "meta.json").write_text(json.dumps({"step": 3, "backend": "orbax"}))
    with pytest.raises(ValueError, match="no params.model"):
        load_model(str(bare), NeRFConfig(), "cpu")


@pytest.mark.parametrize("backend", ["msgpack", None, "tensorstore"])
def test_backend_other_than_orbax_refused(tmp_path, backend):
    """Only ``orbax`` is read (the JAX msgpack fallback cannot write a train
    state); any other backend in meta.json is refused by name, even with a
    ``state.msgpack`` beside it, and never read some other way."""
    from danerf_tpu_torch.config import NeRFConfig
    from danerf_tpu_torch.utils.checkpoint import load_model, read_jax_checkpoint

    meta = {"step": 3} if backend is None else {"step": 3, "backend": backend}
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    (tmp_path / "state.msgpack").write_bytes(b"\x81\xa6params\x80")
    shutil.copytree(os.path.join(FIXTURE, "state"), tmp_path / "state")
    with pytest.raises(ValueError, match=f"backend {backend!r}; only 'orbax'"):
        read_jax_checkpoint(str(tmp_path))
    with pytest.raises(ValueError, match="msgpack fallback cannot write"):
        load_model(str(tmp_path), NeRFConfig(), "cpu")


# ------------------------------------------------- two processes, one checkpoint

FIXTURE_2PROC = os.path.join(DATA, "jax_run_2proc", "checkpoint_000006")


def test_read_two_process_checkpoint_matches_jax_restore():
    """The directory that two ``jax.distributed`` processes saved together
    (``write_jax_checkpoint_2proc.py``: ``tests/mp_worker.py``'s sharded
    train state over 4 devices in 2 processes; Orbax writes the leaves from
    the primary process alone, ``ocdbt.process_0/`` under the root
    manifest): ``read_jax_checkpoint`` against the JAX
    ``restore_checkpoint`` into a single-process template, every leaf bit
    for bit, dtype included, and the metadata."""
    from danerf_tpu.config import NeRFConfig
    from danerf_tpu.train.trainer import create_train_state
    from danerf_tpu.utils.checkpoint import restore_checkpoint
    from danerf_tpu_torch.utils.checkpoint import read_jax_checkpoint

    state_dir = os.path.join(FIXTURE_2PROC, "state")
    assert sorted(d for d in os.listdir(state_dir) if d.startswith("ocdbt.")) == \
        ["ocdbt.process_0"]
    cfg = NeRFConfig(hidden_dim=32, num_layers=2, skip_connect_layers=(), num_samples=8,
                     num_importance=0, batch_size=16, use_bf16=False, use_pallas=False,
                     appearance_dim=4, pos_enc_levels=4, dir_enc_levels=2)
    restored, meta = restore_checkpoint(FIXTURE_2PROC,
                                        create_train_state(jax.random.key(1), cfg, 2))
    tree, got_meta = read_jax_checkpoint(FIXTURE_2PROC)
    assert got_meta == meta
    assert meta["process_count"] == 2 and meta["step"] == 6 and meta["backend"] == "orbax"
    want = _jax_leaves(restored)
    _assert_bit_equal(_leaves(tree), want)
    assert int(want["step"]) == 6
    assert any(np.abs(v).max() > 0 for k, v in want.items() if k.endswith(".mu"))


def test_two_process_fixture_within_its_size_budget():
    root = os.path.join(DATA, "jax_run_2proc")
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root) for f in fs)
    assert size < 60_000, size
