"""PyTorch port, the replicated retrieval protocol (`eval.protocol`) and the
Prospective Cup scorer (`prospective.ProspectiveEvaluator`) against the JAX
package's: the same embedding functions, generators, batches and seed give
the same report (1e-6; both are numpy over copies of one metric module);
`M2SNetCoEmbedding` over the port's frozen M2SNet encoders, restored from a
checkpoint file as `cli.evaluate_protocol` restores them, against JAX's
over `import_m2snet` of the same synthetic weights, in float32 (1e-5 of
the largest value)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.eval import protocol as jax_protocol
from conductor_tpu.interop import import_m2snet
from conductor_tpu.models.m2snet import M2SNet as FlaxM2SNet
from conductor_tpu.prospective import ProspectiveEvaluator as JaxProspective
from conductor_tpu_torch.cli.evaluate_protocol import m2snet_co_embedding
from conductor_tpu_torch.eval import protocol as port_protocol
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.prospective import ProspectiveEvaluator, ProspectiveResult

torch.set_num_threads(2)

N, B, D = 12, 4, 6  # conditions, batch, embedding width


class LinearWrapper:
    """Fixed random projections of flattened conditions and motions."""

    def __init__(self):
        rs = np.random.RandomState(0)
        self.wc, self.wm = rs.normal(size=(10, D)), rs.normal(size=(10, D))

    def embed(self, cond, motion):
        return cond.reshape(len(cond), -1) @ self.wc, self.embed_motion(motion)

    def embed_motion(self, motion):
        return np.asarray(motion).reshape(len(motion), -1) @ self.wm


def _data():
    rs = np.random.RandomState(1)
    conds = rs.normal(size=(N, 10))
    reals = conds[:, ::-1] * 0.5 + 0.1 * rs.normal(size=(N, 10))
    return conds, reals


def batches_fn(rep: int = 0):
    conds, reals = _data()
    order = np.random.default_rng((5, rep)).permutation(N)
    for b0 in range(0, N, B):
        idx = order[b0:b0 + B]
        yield conds[idx], reals[idx]


def generators():
    return {"copy": lambda c: c[:, ::-1] * 0.5, "noisy": lambda c: np.sin(3 * c)}


def mm_generate(cond):
    return np.stack([np.cos(cond * (r + 1)) for r in range(4)])


def _run(mod, mm=True):
    cfg = mod.ProtocolConfig(top_k=2, diversity_times=5, mm_num_times=3, replication_times=3,
                             seed=4)
    conds = [c for c in _data()[0][:5]]
    return mod.EvaluationProtocol(LinearWrapper(), cfg).run(
        batches_fn, generators(), mm_generate=mm_generate if mm else None,
        mm_conds=conds if mm else None)


def _close_summaries(got, want):
    assert list(got) == list(want)
    for metric, models in want.items():
        assert list(got[metric]) == list(models), metric
        for model, (mean, conf) in models.items():
            gm, gc = got[metric][model]
            np.testing.assert_allclose(gm, mean, rtol=1e-6, atol=1e-12, err_msg=(metric, model))
            np.testing.assert_allclose(gc, conf, rtol=1e-6, atol=1e-12, err_msg=(metric, model))


def test_protocol_matches_jax():
    want, got = _run(jax_protocol), _run(port_protocol)
    _close_summaries(got.summary(), want.summary())
    assert got.format_report() == want.format_report()
    summary = got.summary()
    assert set(summary) == {"MatchingScore", "R_precision", "Diversity", "FID", "MultiModality"}
    # reshuffled batches: the ground truth's MatchingScore carries a CI
    assert float(summary["MatchingScore"]["ground truth"][1]) > 0
    np.testing.assert_array_equal(port_protocol.get_metric_statistics(np.arange(4.0))[0], 1.5)


def test_pregenerated_samples_match_jax():
    conds = list(_data()[0])

    def generate_fn(chunk, repeats=1):
        out = np.tanh(chunk * 2.0)
        return out if repeats == 1 else np.stack([out * (r + 1) for r in range(repeats)], axis=1)

    kw = dict(mm_num_samples=3, mm_num_repeats=4, batch_size=5, seed=2)
    want = jax_protocol.PregeneratedSamples(generate_fn, conds, **kw)
    got = port_protocol.PregeneratedSamples(generate_fn, conds, **kw)
    np.testing.assert_array_equal(got.fakes, want.fakes)
    assert list(got.mm_indices) == list(want.mm_indices)
    np.testing.assert_array_equal(got.mm_fakes, want.mm_fakes)
    assert len(got) == N and np.array_equal(got[3][1], want[3][1])
    # replayed into both protocols: the same report
    cfg = dict(top_k=2, diversity_times=5, mm_num_times=3, replication_times=2, seed=0)
    reports = []
    for mod, pre in ((jax_protocol, want), (port_protocol, got)):
        mm_gen, mm_conds = pre.mm_args()
        reports.append(mod.EvaluationProtocol(LinearWrapper(), mod.ProtocolConfig(**cfg)).run(
            batches_fn, {"cached": pre.lookup_generator()}, mm_generate=mm_gen,
            mm_conds=mm_conds).summary())
    _close_summaries(reports[1], reports[0])
    replay = got.generator()
    np.testing.assert_array_equal(replay(np.stack(conds[:B])), want.fakes[:B])
    with pytest.raises(KeyError):
        got.lookup_generator()(np.zeros((1, 10)))


def test_m2snet_co_embedding_matches_jax(tmp_path):
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=3)
    path = tmp_path / "m2snet.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    port = m2snet_co_embedding(str(path), torch.device("cpu"))
    variables = jax.tree.map(jnp.asarray, import_m2snet(sd))
    flax = FlaxM2SNet()
    music_fn = jax.jit(lambda mel: flax.apply(
        variables, mel, method=lambda m, x: m.music_encoder(x, False)).astype(jnp.float32))
    motion_fn = jax.jit(lambda mo: flax.apply(
        variables, mo, method=lambda m, x: m.motion_encoder(x, False)).astype(jnp.float32))
    want = jax_protocol.M2SNetCoEmbedding(music_fn, motion_fn)
    rs = np.random.RandomState(2)
    mel = rs.uniform(0, 1, (2, 270, 128)).astype(np.float32)
    motion = rs.uniform(0, 1, (2, 90, 13, 2)).astype(np.float32)
    for got_emb, want_emb in zip((*port.embed(mel, motion), port.embed_motion(motion)),
                                 (*want.embed(jnp.asarray(mel), jnp.asarray(motion)),
                                  want.embed_motion(jnp.asarray(motion)))):
        want_emb = np.asarray(want_emb)
        assert got_emb.shape == want_emb.shape == (2, 64) and got_emb.dtype == np.float32
        scale = float(np.abs(want_emb).max())
        assert scale > 1e-3
        np.testing.assert_allclose(got_emb, want_emb, rtol=0, atol=1e-5 * scale)


def test_prospective_evaluator_matches_jax():
    rs = np.random.RandomState(3)
    batches = [(rs.uniform(0, 1, (2, 540, 128)).astype(np.float32),
                rs.uniform(0, 1, (2, 180, 13, 2)).astype(np.float32)) for _ in range(2)]

    def generate_fn(mel):  # (B, T30, 26), a motion that follows the mel's energy
        energy = mel.reshape(mel.shape[0], -1, 3, 128).mean(axis=(2, 3))
        return np.repeat(energy[..., None], 26, axis=2) * np.linspace(0.5, 1.5, 26)

    want = JaxProspective(generate_fn).evaluate(batches)
    got = ProspectiveEvaluator(generate_fn).evaluate(batches)
    assert isinstance(got, ProspectiveResult) and list(got.as_dict()) == ["MSE", "RDE", "SCE", "SDP"]
    for k, v in want.as_dict().items():
        assert np.isfinite(v), k
        np.testing.assert_allclose(got.as_dict()[k], v, rtol=1e-6, err_msg=k)


def test_frechet_from_statistics_takes_no_disp(monkeypatch):
    """`calculate_frechet_distance` gives JAX's number without passing
    ``disp`` to `scipy.linalg.sqrtm`, which SciPy 1.18 removed (the
    protocol CLI raised TypeError under it)."""
    from scipy import linalg

    from conductor_tpu.eval.metrics import calculate_frechet_distance as jax_fid
    from conductor_tpu_torch.eval import metrics as port_metrics

    rs = np.random.RandomState(4)
    a, b = rs.normal(size=(40, 6)), rs.normal(size=(40, 6)) + 0.3
    stats = (*port_metrics.calculate_activation_statistics(a),
             *port_metrics.calculate_activation_statistics(b))
    want = jax_fid(*stats)
    sqrtm = linalg.sqrtm

    def sqrtm_without_disp(x, **kw):
        if "disp" in kw:
            raise TypeError("sqrtm() got an unexpected keyword argument 'disp'")
        return sqrtm(x, **kw)

    monkeypatch.setattr(port_metrics.linalg, "sqrtm", sqrtm_without_disp)
    got = port_metrics.calculate_frechet_distance(*stats)
    assert want > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-12)
