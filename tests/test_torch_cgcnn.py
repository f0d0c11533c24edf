"""The port's CGCNN slice against icsg3d_tpu, on the CPU in f32.

- The featurizer: the four graph arrays bitwise equal to JAX's on the
  repo's real CIFs and on synthetic structures; ``gaussian_expand`` within
  rtol 1e-6 / atol 1e-7 (one f32 exp per element).
- The forward at full width (B = 4, N = 50, M = 12, 93 -> 64, 41 centres,
  hidden 128) on random and on featurized graphs, and at a tiny width with
  exact zeros placed so that both count_nonzero quirks of the masked BN
  decide the result: predictions within rtol 1e-5 / atol 1e-6 of
  ``CGCNN.apply``.
- Three train steps against ``make_cgcnn_steps`` at full width, batch 8:
  losses rel 1e-5, every parameter's gradient within 1e-4 of its max|g|.
- ``predict_from_cifs`` and ``generate --cgcnn-ckpt --device cpu`` against
  the JAX functions on the same weights, which reach the port through
  ``tools/export_flax_npz.py --cgcnn-out`` (the export round trip):
  rtol 1e-5 / atol 5e-6 (see PRED_ATOL).
- ``train_cgcnn`` CLI: history, best/latest, ``--resume``.

Weights are the Flax tree (every leaf randomised, seeded with numpy)
carried into the port by ``weights.load_flax_variables``.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icsg3d_torch import config as tcfg
from icsg3d_torch import weights
from icsg3d_torch.apps import common as tcommon
from icsg3d_torch.apps import generate as tgen
from icsg3d_torch.apps import predict as tpredict
from icsg3d_torch.apps import train_cgcnn as ttrain
from icsg3d_torch.data import graphs as tgraphs
from icsg3d_torch.models import cgcnn as tmodel
from icsg3d_torch.train import cgcnn as tcg
from icsg3d_tpu.apps import generate as jgen
from icsg3d_tpu.apps import predict as jpredict
from icsg3d_tpu.config import CGCNNConfig, TrainConfig
from icsg3d_tpu.crystal.cif import read_cif
from icsg3d_tpu.crystal.structure import Structure as JStructure
from icsg3d_tpu.data import graphs as jgraphs
from icsg3d_tpu.data import synthetic as jsynthetic
from icsg3d_tpu.models.cgcnn import CGCNN
from icsg3d_tpu.train import cgcnn as jcg
from test_torch_generate import _blob_dataset, _load_export_script

torch.set_num_threads(1)

REAL_CIFS = pathlib.Path(__file__).resolve().parent / "fixtures" / "real_cifs"
RTOL, ATOL = 1e-5, 1e-6
# End to end on the JAX package's fresh init: its predictions are ~1e-2,
# while the 128 terms of the output product sum to O(1), so their f32
# rounding (another summation order) is ~1e-6 absolute.
PRED_ATOL = 5e-6
GRAPH_KEYS = ("atom_fea", "nbr_dist", "nbr_idx", "atom_mask")
TINY = dict(atom_input_dim=6, atom_fea_len=4, max_atoms=6, max_neighbors=3,
            radius=2.0, step=0.5, hidden_dim=8)


def random_graphs(cfg, n_atoms, seed):
    """Padded graph arrays as featurize_batch lays them out: sparse binary
    atom features, random in-structure neighbours, padded rows pointing at
    the last slot at distance radius + 1."""
    rng = np.random.default_rng(seed)
    B, N, M = len(n_atoms), cfg.max_atoms, cfg.max_neighbors
    atom_fea = (rng.random((B, N, cfg.atom_input_dim)) < 0.15).astype(np.float32)
    nbr_dist = rng.uniform(0.5, cfg.radius, (B, N, M)).astype(np.float32)
    nbr_idx = np.full((B, N, M), N - 1, np.int32)
    mask = np.zeros((B, N), np.float32)
    for b, n in enumerate(n_atoms):
        mask[b, :n] = 1.0
        atom_fea[b, n:] = 0.0
        nbr_dist[b, n:] = cfg.radius + 1.0
        nbr_idx[b, :n] = rng.integers(0, n, (n, M))
    return dict(atom_fea=atom_fea, nbr_dist=nbr_dist, nbr_idx=nbr_idx,
                atom_mask=mask)


def randomized_variables(cfg, seed):
    """The Flax CGCNN's variables with every leaf drawn from a seed."""
    model = CGCNN(cfg)
    g = random_graphs(cfg, [cfg.max_atoms], 0)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), *(jnp.asarray(g[k]) for k in GRAPH_KEYS)))
    rng = np.random.default_rng(seed)
    out = {}
    for key, s in sorted(weights.flatten(jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), shapes)).items()):
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":
            v = rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
        elif leaf.startswith("gamma"):
            v = 1.0 + 0.2 * rng.standard_normal(s.shape)
        else:
            v = 0.1 * rng.standard_normal(s.shape)
        out[key] = v.astype(np.float32)
    return model, weights.unflatten(out)


def port_model(cfg, variables):
    model = tmodel.CGCNN(tcfg.CGCNNConfig(**{
        f: getattr(cfg, f) for f in CGCNNConfig.__dataclass_fields__}))
    weights.load_flax_variables(model, variables)
    return model


def both_predict(model, variables, port, g):
    want = np.asarray(model.apply(variables, *(jnp.asarray(g[k]) for k in GRAPH_KEYS)))
    with torch.no_grad():
        got = port(*(torch.from_numpy(g[k]) for k in GRAPH_KEYS)).numpy()
    return got, want


def real_structures():
    out = []
    for path in sorted(REAL_CIFS.glob("*.cif")):
        s = read_cif(str(path))
        if 0 < len(s) <= CGCNNConfig().max_atoms:
            out.append(s)
    return out


def synthetic_structures(n=12, seed=3):
    return jsynthetic.random_structures(n, seed=seed, kinds=("perovskite", "rocksalt"))


@pytest.mark.parametrize("source", ["real_cifs", "synthetic"])
def test_featurizer_is_bitwise_jax(source):
    structures = real_structures() if source == "real_cifs" else synthetic_structures()
    assert len(structures) >= 12
    spec = jgraphs.GraphSpec()
    want = jgraphs.featurize_batch(structures, spec)
    got = tgraphs.featurize_batch(structures, tgraphs.GraphSpec())
    assert set(got) == set(want) == set(GRAPH_KEYS)
    for k in GRAPH_KEYS:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_gaussian_expand_matches_jax():
    spec = CGCNNConfig()
    rng = np.random.default_rng(1)
    d = rng.uniform(0.0, 9.0, (3, 50, 12)).astype(np.float32)
    d[0, 40:] = spec.radius + 1.0  # the featurizer's pad distance
    jspec = jgraphs.GraphSpec()
    want = np.asarray(jgraphs.gaussian_expand(jnp.asarray(d), jspec))
    got = tgraphs.gaussian_expand(torch.from_numpy(d), tgraphs.GraphSpec()).numpy()
    assert got.shape == want.shape == (3, 50, 12, 41)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("graphs", ["random", "featurized"])
def test_forward_full_width_matches_jax(graphs):
    cfg = CGCNNConfig()
    model, variables = randomized_variables(cfg, seed=4)
    port = port_model(cfg, variables)
    if graphs == "random":
        g = random_graphs(cfg, [50, 37, 5, 20], seed=5)
    else:
        g = jgraphs.featurize_batch(real_structures()[:4], jgraphs.GraphSpec())
    assert g["nbr_idx"].shape == (4, 50, 12)
    got, want = both_predict(model, variables, port, g)
    assert np.isfinite(want).all() and want.std() > 1e-3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _count_by_mask(x, mask, count_from_values=True, group=None):
    """The masked-BN statistics with mask counts, which the reference does
    not use: the tiny case must tell the two apart."""
    x, mask = x.float(), mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    mu = x.sum() / n
    return mu, (torch.square(x - mu) * mask).sum() / n


def test_forward_count_nonzero_quirks_match_jax(monkeypatch):
    """Exact zeros in real entries: Dense_0's column 0 of the conv is all
    zero (gated[..., 0] == 0 for every real edge: BN 1 leaves it out of its
    count), and core channel 1 gets gamma1 0, beta1 -200 (softplus 0, so
    summed[..., 1] == 0 on real atoms: BN 2's mean leaves it out, while its
    variance, divided by count_nonzero of the squared differences, takes it
    in)."""
    cfg = CGCNNConfig(**TINY)
    model, variables = randomized_variables(cfg, seed=6)
    conv = variables["params"]["CrystalGraphConv_0"]
    conv["Dense_0"]["kernel"][:, 0] = 0.0
    conv["Dense_0"]["bias"][0] = 0.0
    F = cfg.atom_fea_len
    conv["gamma1"][F + 1] = 0.0
    conv["beta1"][F + 1] = -200.0
    port = port_model(cfg, variables)
    g = random_graphs(cfg, [6, 3, 1], seed=7)
    got, want = both_predict(model, variables, port, g)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)

    x = torch.from_numpy(g["atom_fea"])
    with torch.no_grad():
        h = port.Dense_0(x, torch.float32)
        conv_t = port.CrystalGraphConv_0
        nbr = tgraphs.gaussian_expand(torch.from_numpy(g["nbr_dist"]), port.spec)
        idx = torch.from_numpy(g["nbr_idx"]).long()
        total = torch.cat([h[:, :, None].expand(-1, -1, 3, -1),
                           torch.stack([h[b][idx[b]] for b in range(3)]), nbr], -1)
        gated = conv_t.Dense_0(total, torch.float32) * torch.from_numpy(
            g["atom_mask"])[:, :, None, None]
    n_real_edges = int(g["atom_mask"].sum()) * cfg.max_neighbors * 2 * F
    assert int(torch.count_nonzero(gated)) < n_real_edges  # quirk 1 in play
    monkeypatch.setattr(tmodel, "_masked_batch_stats", _count_by_mask)
    with torch.no_grad():
        naive = port(*(torch.from_numpy(g[k]) for k in GRAPH_KEYS)).numpy()
    assert np.abs(naive - want).max() > 1e-3  # the quirks decide the result


def test_masked_mean_pool_and_max_pool_match_jax():
    from icsg3d_tpu.models import cgcnn as jmodel

    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 5)).astype(np.float32)
    x[0, 4:] = 0.0
    x[1, 2] = 0.0
    np.testing.assert_allclose(
        tmodel.masked_mean_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.masked_mean_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        tmodel.max_pool(torch.from_numpy(x)).numpy(),
        np.asarray(jmodel.max_pool(jnp.asarray(x))))


def test_softplus_is_flax_logaddexp():
    x = np.array([-300.0, -30.0, -1.0, 0.0, 1e-3, 5.0, 19.0, 21.0, 60.0],
                 np.float32)
    np.testing.assert_allclose(
        tmodel.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=1e-6, atol=0)


def test_three_train_steps_match_jax():
    cfg = CGCNNConfig()
    jm, jstate = jcg.create_cgcnn_state(cfg, TrainConfig(learning_rate=1e-3),
                                        jax.random.key(0))
    _, variables = randomized_variables(cfg, seed=9)
    jstate = jstate.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                          variables["params"]))
    jtrain, _ = jcg.make_cgcnn_steps(jm)
    jgrad = jax.jit(jax.grad(lambda p, b: jcg._cgcnn_losses(jm, p, b)[0]))
    tstate = tcg.create_cgcnn_state(tcfg.CGCNNConfig(), 1e-3, 0, "cpu")
    weights.load_flax_variables(tstate.model, variables)
    ttrain_step, teval = tcg.make_cgcnn_steps(tstate.model)
    for step in range(3):
        rng = np.random.default_rng(10 + step)
        g = random_graphs(cfg, rng.integers(1, 51, 8).tolist(), seed=20 + step)
        g["target"] = rng.standard_normal(8).astype(np.float32)
        jb = {k: jnp.asarray(v) for k, v in g.items()}
        jgrads = jgrad(jstate.params, jb)
        jstate, jmets = jtrain(jstate, jb)
        tmets = ttrain_step(tstate, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in ("loss", "mae"):
            np.testing.assert_allclose(float(tmets[k]), float(jmets[k]), rtol=1e-5,
                                       err_msg=f"step {step} {k}")
        tgrads = {weights.flax_key(n): p.grad.numpy()
                  for n, p in tstate.model.named_parameters()}
        jflat = weights.flatten({"params": jax.tree_util.tree_map(np.asarray, jgrads)})
        assert set(tgrads) == set(jflat)
        for k, gj in jflat.items():
            scale = float(np.abs(gj).max())
            assert scale > 0, k
            assert np.abs(tgrads[k] - gj).max() <= 1e-4 * scale, (step, k)
    assert tstate.step == 3
    mets = teval(tstate, {k: torch.from_numpy(v) for k, v in g.items()})
    assert set(mets) == {"loss", "mae"}


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX package's fresh-init CGCNN (key 0: what its CLIs load for a
    checkpoint path with no checkpoint) exported by the export script."""
    path = tmp_path_factory.mktemp("cgcnn") / "cgcnn.npz"
    _load_export_script()(["--cgcnn-out", str(path)])
    return str(path)


def test_export_round_trip_predicts_like_jax(exported):
    from icsg3d_tpu.apps import common as jcommon

    jm, jvars = jcommon.load_cgcnn(CGCNNConfig(), None)
    port = tcommon.load_cgcnn(tcfg.CGCNNConfig(), exported, device="cpu")
    assert not port.training
    g = jgraphs.featurize_batch(synthetic_structures(), jgraphs.GraphSpec())
    got, want = both_predict(jm, jvars, port, g)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=PRED_ATOL)


def test_predict_from_cifs_matches_jax(exported):
    paths = sorted(str(p) for p in REAL_CIFS.glob("*.cif"))
    paths.append(str(REAL_CIFS / "oracles.json"))  # unparseable: an error record
    want = jpredict.predict_from_cifs(paths, {"fe": None, "bg": None}, batch_size=8)
    got = tpredict.predict_from_cifs(paths, {"fe": exported, "bg": exported},
                                     batch_size=8, device="cpu")
    assert len(got) == len(want) == len(paths)
    assert sum("properties" in r for r in want) >= 12
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in ("cif", "formula", "error"):
            assert g.get(k) == w.get(k), k
        if "properties" in w:
            for prop in ("fe", "bg"):
                np.testing.assert_allclose(g["properties"][prop], w["properties"][prop],
                                           rtol=RTOL, atol=PRED_ATOL)


def test_predict_cli_writes_records(exported, tmp_path, capsys):
    out = tmp_path / "pred.json"
    recs = tpredict.main([str(REAL_CIFS), "--ckpt", f"fe={exported}",
                          "--batch-size", "32", "--device", "cpu",
                          "--output", str(out)])
    assert json.loads(out.read_text()) == recs
    assert json.loads(capsys.readouterr().out) == recs
    assert all(np.isfinite(r["properties"]["fe"]) for r in recs if "error" not in r)


@pytest.fixture(scope="module")
def generation_weights(tmp_path_factory):
    """A d = 8 blob dataset and seeded port weights (VAE filters 4, 8,
    latent 8; the full-width U-Net).  The VAE's coordinate outputs are
    scaled x 10 (cells of a few Angstrom, not the ~0.5 of random weights,
    whose 8 Angstrom neighbour search walks thousands of images), and the
    occupancy head so that ~30% of the decoded voxels pass the 0.8
    threshold: the fused extraction then finds structures to score."""
    from icsg3d_torch.models import ConditionalDFCVAE, UNet3D

    tmp = tmp_path_factory.mktemp("gen-cgcnn")
    _blob_dataset(tmp / "data")
    gen = torch.Generator().manual_seed(0)
    vae = ConditionalDFCVAE(tcfg.VAEConfig(grid=tcfg.GridSpec(d=8), filters=(4, 8),
                                           latent_dim=8, dtype="float32"), gen).eval()
    unet = UNet3D(tcfg.UNetConfig(dtype="float32"), gen).eval()
    with torch.no_grad():
        vae.decoder.output_bn.weight[1:] *= 10.0
        vae.decoder.output_bn.bias[1:] *= 10.0
    z = torch.from_numpy(np.random.default_rng(1).standard_normal((4, 8)).astype(np.float32))
    cond = torch.eye(10)[[1, 1, 1, 1]]
    with torch.no_grad():
        logits = unet(vae.decode(z, cond))[1].double().flatten()
        q, a = float(torch.quantile(logits, 0.7)), 6.0 / float(logits.std())
        unet.head_sig.kernel.mul_(a)  # logit -> a * (logit - q) + logit(0.8)
        unet.head_sig.bias.copy_(a * (unet.head_sig.bias - q) + float(np.log(4.0)))
    paths = {"tmp": tmp, "vae": str(tmp / "vae.npz"), "unet": str(tmp / "unet.npz")}
    weights.save_npz(paths["vae"], weights.to_flax_variables(vae))
    weights.save_npz(paths["unet"], weights.to_flax_variables(unet))
    return paths


def test_generate_cgcnn_ckpt_matches_jax(generation_weights, exported):
    """``generate --fused --cgcnn-ckpt`` on the CPU: every extracted
    structure's two properties equal JAX ``predict_properties`` on the same
    structures and weights, before the records are annotated."""
    c = generation_weights
    records = tgen.main([
        "--data", str(c["tmp"] / "data"), "--base", "s1",
        "--vae-ckpt", c["vae"], "--unet-ckpt", c["unet"],
        "--filters", "4,8", "--latent", "8", "--nsamples", "3",
        "--batch-size", "2", "--device", "cpu", "--fused",
        "--output", str(c["tmp"] / "out"),
        "--cgcnn-ckpt", f"formation_energy_per_atom={exported},band_gap={exported}",
    ])
    with_structure = [r for r in records if r.get("structure") is not None]
    assert len(with_structure) >= 2
    ref = [{"structure": JStructure.from_cartesian(
        np.asarray(r["lattice"], np.float32), np.asarray(r["atoms"]),
        np.asarray(r["coords"]))} for r in with_structure]
    jgen.predict_properties(ref, CGCNNConfig(), {"formation_energy_per_atom": None,
                                                 "band_gap": None})
    for r, w in zip(with_structure, ref):
        assert set(r["properties"]) == set(w["properties"]) == {
            "formation_energy_per_atom", "band_gap"}
        for prop, v in w["properties"].items():
            np.testing.assert_allclose(r["properties"][prop], v, rtol=RTOL,
                                       atol=PRED_ATOL)
        assert "target_diff_pct" in r  # annotate_records saw the prediction
    rows = json.loads((c["tmp"] / "out" / "results.json").read_text())
    assert [r.get("properties") for r in rows] == [r.get("properties") for r in records]


def test_predict_properties_skips_oversized_structures(capsys):
    """Structures outside 1..50 atoms (the fused extractor emits up to 64)
    are skipped with the JAX package's message; records without a
    structure are left alone."""
    from icsg3d_torch.crystal.structure import Structure as TStructure
    from icsg3d_torch.data import synthetic as tsynthetic

    cart = np.random.default_rng(0).uniform(0, 20, (51, 3))
    out = {}
    for pkg, cls, predict, cfg, kw, syn in (
            ("torch", TStructure, tgen.predict_properties, tcfg.CGCNNConfig(),
             {"device": "cpu"}, tsynthetic),
            ("jax", JStructure, jgen.predict_properties, CGCNNConfig(), {}, jsynthetic)):
        small = syn.random_structures(2, seed=3, kinds=("perovskite", "rocksalt"))
        big = cls.from_cartesian(np.full(3, 20.0), np.full(51, 8), cart)
        recs = [{"structure": s} for s in small + [big]] + [{"valid": False}]
        predict(recs, cfg, {"fe": None}, **kw)
        msg = capsys.readouterr().out
        assert "skipping 1 structure(s) outside 1..50 atoms" in msg, pkg
        out[pkg] = [("properties" in r) for r in recs]
    assert out["torch"] == out["jax"] == [True, True, False, False]


def test_train_cgcnn_cli_and_resume(tmp_path):
    ck = tmp_path / "ck"
    base = ["--synthetic", "40", "--batch-size", "8", "--device", "cpu",
            "--ckpt", str(ck)]
    hist = ttrain.main(base + ["--epochs", "2", "--synthetic-property", "band_gap"])
    assert len(hist) == 2 and all(h["steps"] == 4 for h in hist)
    assert all(np.isfinite(h[s][m]) for h in hist for s in ("train", "val")
               for m in ("loss", "mae"))
    for name in ("best.npz", "latest.npz", "history.json", "best_metric.json"):
        assert (ck / name).exists(), name
    with np.load(ck / "best.npz") as f:
        assert "params/CrystalGraphConv_0/gamma1" in f.files
    more = ttrain.main(base + ["--epochs", "1", "--resume",
                               "--synthetic-property", "band_gap"])
    assert len(more) == 1
    assert len(json.loads((ck / "history.json").read_text())) == 3
    model = tcommon.load_cgcnn(tcfg.CGCNNConfig(), str(ck), device="cpu")
    assert np.isfinite(tcommon.cgcnn_predict(
        model, tgraphs.featurize_batch(synthetic_structures(3), tgraphs.GraphSpec()))
    ).all()


def test_train_cgcnn_refuses_a_split_smaller_than_a_batch(tmp_path):
    with pytest.raises(ValueError, match="no train batches"):
        ttrain.main(["--synthetic", "6", "--batch-size", "8", "--epochs", "1",
                     "--device", "cpu", "--ckpt", str(tmp_path / "ck")])


def test_train_cgcnn_from_cifs(tmp_path):
    hist = ttrain.main(["--cifs", str(REAL_CIFS), "--targets-csv",
                        str(REAL_CIFS / "targets.csv"), "--batch-size", "4",
                        "--epochs", "1", "--device", "cpu", "--ckpt", str(tmp_path)])
    assert len(hist) == 1 and hist[0]["steps"] >= 1
