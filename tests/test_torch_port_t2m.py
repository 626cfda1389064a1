"""PyTorch port, the text-to-motion stack: `conductor_tpu_torch.t2m`
against `conductor_tpu.t2m` on the CPU, the same numpy inputs through both.

- Quaternion ops and cont6d within 1e-5 absolute (`qeuler` in degrees
  within 1e-4, on angles away from gimbal lock); JAX's side in one jit.
- `Skeleton` FK / IK, `recover_*`, `uniform_skeleton`, `process_file` and
  `extract_*` within 1e-4 of the largest absolute value at T = 40, 22
  joints, on a walking motion; foot contacts equal, the threshold set in
  the widest relative gap among the middle half of the motion's squared
  foot displacements.
- The evaluator within 1e-5 of the largest embedding value, on weights that
  cross as one `finest.tar`-layout file (the port's `save_torch_checkpoint`
  read by JAX's own `load_torch_checkpoint` and the port's loader): the
  modules at narrow widths (B = 3, T = 32, unsorted lengths with the full
  one; junk past a clip's length), the wrapper at the published widths (B
  = 2, T = 16).  JAX's modules are jitted once a module (`_Jitted`), as
  their eager applies recompile at every call.
- `WordVectorizer` and `Text2MotionDataset` items bit for bit on synthetic
  GloVe files and `joints` / `texts` folders; the refusals.
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.t2m import dataset as jax_dataset
from conductor_tpu.t2m import evaluator_models as jax_eval
from conductor_tpu.t2m import motion_process as jax_mp
from conductor_tpu.t2m import quaternion as jax_q
from conductor_tpu.t2m import skeleton as jax_skel
from conductor_tpu.t2m import word_vectorizer as jax_wv
from conductor_tpu_torch.models.generator import gru_plain
from conductor_tpu_torch.t2m import dataset, motion_process, param_util, plot_3d
from conductor_tpu_torch.t2m import quaternion as Q
from conductor_tpu_torch.t2m import skeleton, word_vectorizer
from conductor_tpu_torch.t2m.evaluator_models import (
    MotionEncoderBiGRUCo,
    MovementConvEncoder,
    T2MEvaluatorWrapper,
    TextEncoderBiGRUCo,
    bigru_co_plain,
    load_torch_checkpoint,
    save_torch_checkpoint,
)

torch.set_num_threads(2)

T, J = 40, 22
FACE = (2, 1, 17, 16)
ORDERS = ("xyz", "yzx", "zxy", "xzy", "yxz", "zyx")


def _close(got, want, rel=None, atol=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    bound = atol if atol is not None else rel * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= bound, f"max_abs_err {err:.3g} > {bound:.3g}"


# ------------------------------------------------------------ quaternions

def _unit(rng, *shape):
    q = rng.normal(size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _quat_inputs():
    rng = np.random.default_rng(0)
    n = 64
    seq = _unit(rng, 12, 3)
    seq[rng.random((12, 3)) < 0.4] *= -1  # sign flips for qfix
    angles = np.stack([rng.uniform(-170, 170, n), rng.uniform(-70, 70, n),
                       rng.uniform(-170, 170, n)], -1)
    e64 = torch.from_numpy(angles)
    a = {"q_raw": rng.normal(size=(n, 4)).astype(np.float32), "q": _unit(rng, n),
         "r": _unit(rng, n), "v": rng.normal(size=(n, 3)).astype(np.float32),
         "w": rng.normal(size=(n, 3)).astype(np.float32),
         "e": rng.uniform(-1.8, 1.8, (n, 3)).astype(np.float32),
         "c6": rng.normal(size=(n, 6)).astype(np.float32),
         "t": rng.uniform(0, 1, (n, 1)).astype(np.float32), "q_seq": seq,
         "angles": angles.astype(np.float32)}
    for o in ORDERS:  # away from gimbal lock: the middle angle within +-70 degrees
        a[f"q_{o}"] = Q.euler2quat(e64, o).numpy().astype(np.float32)
    return a


QUAT_OPS = {
    "qnormalize": lambda M, a: M.qnormalize(a["q_raw"]),
    "qinv": lambda M, a: M.qinv(a["q"]),
    "qmul": lambda M, a: M.qmul(a["q"], a["r"]),
    "qrot": lambda M, a: M.qrot(a["q"], a["v"]),
    "qfix": lambda M, a: M.qfix(a["q_seq"]),
    "expmap_to_quaternion": lambda M, a: M.expmap_to_quaternion(a["e"]),
    "quaternion_to_matrix": lambda M, a: M.quaternion_to_matrix(a["q_raw"]),
    "quaternion_to_cont6d": lambda M, a: M.quaternion_to_cont6d(a["q_raw"]),
    "cont6d_to_matrix": lambda M, a: M.cont6d_to_matrix(a["c6"]),
    "qpow": lambda M, a: M.qpow(a["q"], a["t"]),
    "qslerp": lambda M, a: M.qslerp(a["q"], a["r"], a["t"]),
    "qbetween": lambda M, a: M.qbetween(a["v"], a["w"]),
    "lerp": lambda M, a: M.lerp(a["v"], a["w"], a["t"]),
    "qeuler_rad_eps": lambda M, a: M.qeuler(a["q"], "xyz", epsilon=1e-3, deg=False),
    **{f"qeuler_{o}": (lambda o: lambda M, a: M.qeuler(a[f"q_{o}"], o))(o) for o in ORDERS},
    **{f"euler2quat_{o}": (lambda o: lambda M, a: M.euler2quat(a["angles"], o))(o)
       for o in ORDERS},
}


@pytest.fixture(scope="module")
def quats():
    a = _quat_inputs()
    want = jax.jit(lambda x: {k: f(jax_q, x) for k, f in QUAT_OPS.items()})(
        {k: jnp.asarray(v) for k, v in a.items()})
    return a, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("op", list(QUAT_OPS))
def test_quaternion_op_matches_jax(quats, op):
    a, want = quats
    got = QUAT_OPS[op](Q, {k: torch.from_numpy(v) for k, v in a.items()})
    assert got.dtype == torch.float32
    _close(got.numpy(), want[op], atol=1e-4 if op.startswith("qeuler_") else 1e-5)


def test_qfix_flips_by_the_original_sequence():
    """Frame t is flipped by the parity of negative dot products between the
    original frames up to t, so consecutive flipped frames stay aligned."""
    q = torch.tensor([[1.0, 0, 0, 0], [-1.0, 0, 0, 0], [-1.0, 0, 0, 0], [1.0, 0, 0, 0]])[:, None]
    np.testing.assert_array_equal(Q.qfix(q)[:, 0, 0].numpy(), [1.0, 1.0, 1.0, 1.0])


# --------------------------------------------------------------- skeleton

def _walking_motion() -> np.ndarray:
    """A synthetic global-joint motion (T, J, 3): a rest pose drifting in x
    with a slow yaw and small per-joint wobble (`tests/test_t2m.py:285`),
    its rotations from a numpy seed."""
    rng = np.random.default_rng(11)
    q = np.concatenate([np.ones((T, J, 1)), 0.03 * rng.normal(size=(T, J, 3))], -1)
    root = np.stack([np.linspace(0, 0.5, T), 0.9 + np.zeros(T), 0.1 * np.linspace(0, 1, T)], -1)
    skel = skeleton.Skeleton(param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
    skel.set_offset(np.asarray(param_util.t2m_raw_offsets, np.float32) * 0.25)
    return skel.forward_kinematics(Q.qnormalize(torch.tensor(q, dtype=torch.float32)),
                                   root).numpy()


def _skeletons():
    args = (param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
    return jax_skel.Skeleton(*args), skeleton.Skeleton(*args)


TGT = np.asarray(param_util.t2m_raw_offsets, np.float32) * 0.4


@pytest.fixture(scope="module")
def processed():
    """JAX's and the port's `process_file` on the walking motion, with
    ``feet_thre`` in the widest relative gap among the middle half of the
    feet's squared displacements (so contacts cannot flip by rounding)."""
    pos = _walking_motion()
    chain = (param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
    glob = motion_process.process_file(pos, 0.0, TGT, *chain, device="cpu")[1]
    fid = list(motion_process.T2M_FID_L) + list(motion_process.T2M_FID_R)
    d2 = np.sort(((glob[1:, fid] - glob[:-1, fid]) ** 2).sum(-1).ravel())
    lo = len(d2) // 4  # the widest relative gap in the middle half
    i = lo + int(np.argmax(np.diff(d2[lo:3 * lo + 1]) / d2[lo + 1:3 * lo + 1]))
    thre = float((d2[i] + d2[i + 1]) / 2)
    assert d2[i] < thre * 0.99 and d2[i + 1] > thre * 1.01, d2
    want = jax_mp.process_file(pos, thre, TGT, *chain)
    got = motion_process.process_file(pos, thre, TGT, *chain, device="cpu")
    return pos, thre, want, got


@pytest.mark.parametrize("part", ["data", "global_positions", "local_positions", "l_velocity"])
def test_process_file_matches_jax(processed, part):
    _, _, want, got = processed
    i = ["data", "global_positions", "local_positions", "l_velocity"].index(part)
    assert got[i].dtype == np.float32
    _close(got[i], want[i], rel=1e-4)


def test_process_file_layout_and_foot_contacts(processed):
    """263 channels a frame for 22 joints; the contacts (the last 4) equal
    JAX's exactly, both values present; on the floor, the root at the
    origin and facing +z at frame 0."""
    _, _, want, got = processed
    data, glob = got[0], got[1]
    assert data.shape == (T - 1, 4 + (J - 1) * 3 + (J - 1) * 6 + J * 3 + 4) == (T - 1, 263)
    np.testing.assert_array_equal(data[:, -4:], want[0][:, -4:])
    assert set(np.unique(data[:, -4:])) == {0.0, 1.0}
    np.testing.assert_allclose(glob[:, :, 1].min(), 0.0, atol=1e-6)
    np.testing.assert_allclose(glob[0, 0, [0, 2]], 0.0, atol=1e-6)


def test_uniform_skeleton_matches_jax(processed):
    pos = processed[0]
    chain = (param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
    _close(motion_process.uniform_skeleton(pos, TGT, *chain, device="cpu"),
           jax_mp.uniform_skeleton(pos, TGT, *chain), rel=1e-4)


def test_extract_ric_features_matches_jax(processed):
    """On process_file's own positions: the port's features of them are its
    process_file's, and of JAX's positions within 1e-4 of JAX's (which
    its process_file extracted from those positions)."""
    _, thre, want, got = processed
    args = (thre, param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain, FACE,
            motion_process.T2M_FID_R, motion_process.T2M_FID_L)
    np.testing.assert_array_equal(
        motion_process.extract_ric_features(got[1], *args, device="cpu"), got[0])
    feats = motion_process.extract_ric_features(want[1], *args, device="cpu")
    _close(feats, want[0], rel=1e-4)
    np.testing.assert_array_equal(feats[:, -4:], want[0][:, -4:])


def test_extract_features_kit_layout():
    """KIT's 21 joints give 251 channels a frame."""
    skel = skeleton.Skeleton(param_util.kit_raw_offsets, param_util.kit_kinematic_chain)
    skel.set_offset(np.asarray(param_util.kit_raw_offsets, np.float32) * 0.2)
    rng = np.random.default_rng(3)
    q = Q.qnormalize(torch.tensor(np.concatenate(
        [np.ones((12, 21, 1)), 0.05 * rng.normal(size=(12, 21, 3))], -1), dtype=torch.float32))
    pos = skel.forward_kinematics(q, torch.tensor([[0.0, 1.0, 0.05 * t] for t in range(12)]))
    feats = motion_process.extract_ric_features(
        pos.numpy(), 0.002, param_util.kit_raw_offsets, param_util.kit_kinematic_chain,
        (11, 16, 5, 8), (14, 15), (19, 20), device="cpu")
    assert feats.shape == (11, 251) and np.isfinite(feats).all()


@pytest.mark.parametrize("case", ["offsets", "no_root_R", "skel_joints"])
def test_forward_kinematics_matches_jax(processed, case):
    rng = np.random.default_rng(5)
    q = _unit(rng, T, J)
    root = rng.normal(size=(T, 3)).astype(np.float32)
    js, ps = _skeletons()
    kw = {}
    if case == "skel_joints":
        kw["skel_joints"] = processed[0]
    else:
        for s in (js, ps):
            s.set_offset(TGT)
        kw["do_root_R"] = case == "offsets"
    _close(ps.forward_kinematics(torch.from_numpy(q), torch.from_numpy(root), **kw),
           js.forward_kinematics(q, root, **kw), rel=1e-4)


@pytest.mark.parametrize("smooth", [False, True])
def test_inverse_kinematics_matches_jax(processed, smooth):
    pos = processed[2][1].astype(np.float32)  # JAX's floored, +z-facing positions
    js, ps = _skeletons()
    _close(ps.inverse_kinematics(torch.from_numpy(pos), FACE, smooth_forward=smooth),
           js.inverse_kinematics(pos, FACE, smooth_forward=smooth), rel=1e-4)


def test_get_offsets_joints_matches_jax(processed):
    js, ps = _skeletons()
    got = ps.get_offsets_joints(torch.from_numpy(processed[0][0]))
    _close(got, js.get_offsets_joints(processed[0][0]), rel=1e-4)
    assert ps.offset() is got


def test_recover_matches_jax(processed):
    """recover_root_rot_pos / recover_from_ric / recover_from_rot (FK on the
    6-D rotations, as `Skeleton.forward_kinematics_cont6d`) on the
    extracted features; JAX's sides jitted."""
    data = processed[2][0].astype(np.float32)
    js, ps = _skeletons()
    for s in (js, ps):
        s.set_offset(TGT)
    x = torch.from_numpy(data)
    rq, rp = motion_process.recover_root_rot_pos(x)
    jrq, jrp = jax.jit(jax_mp.recover_root_rot_pos)(data)
    _close(rq, jrq, rel=1e-4)
    _close(rp, jrp, rel=1e-4)
    _close(motion_process.recover_from_ric(x, J),
           jax.jit(lambda d: jax_mp.recover_from_ric(d, J))(data), rel=1e-4)
    _close(motion_process.recover_from_rot(x, J, ps),
           jax.jit(lambda d: jax_mp.recover_from_rot(d, J, js))(data), rel=1e-4)


def test_numpy_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos = np.zeros((4, J, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        motion_process.process_file(pos, 0.002, TGT, param_util.t2m_raw_offsets,
                                    param_util.t2m_kinematic_chain)
    with pytest.raises(RuntimeError, match="CUDA"):
        T2MEvaluatorWrapper("t2m")


# -------------------------------------------------------------- evaluator

class _Jitted:
    """A flax module whose ``apply`` is jitted once: JAX's wrapper calls it
    as it calls the module."""

    def __init__(self, module):
        self.apply = jax.jit(module.apply)


NARROW = {"movement": (48, 32), "text": (32, 16), "motion": (64, 16)}  # (hidden, output)


def _narrow_port_wrapper() -> T2MEvaluatorWrapper:
    w = T2MEvaluatorWrapper("t2m", device="cpu")
    w.movement_enc = MovementConvEncoder(259, *NARROW["movement"]).eval()
    w.text_enc = TextEncoderBiGRUCo(300, 15, *NARROW["text"]).eval()
    w.motion_enc = MotionEncoderBiGRUCo(NARROW["movement"][1], *NARROW["motion"]).eval()
    return w


def _crossing(tmp_path, w: T2MEvaluatorWrapper, seed: int, noise: bool = True):
    """``w``'s weights drawn from a generator, with ``noise`` every parameter
    then moved by seeded noise (so no bias is zero and no LayerNorm is the
    identity), written as one `finest.tar`-layout file; returns its path."""
    state = w.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    for sd in state.values() if noise else ():
        for v in sd.values():
            v.add_(torch.from_numpy(rng.normal(0, 0.1, v.shape).astype(np.float32)))
    path = str(tmp_path / "finest.tar")
    save_torch_checkpoint(path, w.state_dict())
    return path


def _jax_wrapper(path: str, narrow: bool):
    jw = jax_eval.T2MEvaluatorWrapper("t2m", jax_eval.load_torch_checkpoint(path))
    if narrow:
        jw.movement_enc = jax_eval.MovementConvEncoder(*NARROW["movement"])
        jw.text_enc = jax_eval.TextEncoderBiGRUCo(*NARROW["text"])
        jw.motion_enc = jax_eval.MotionEncoderBiGRUCo(*NARROW["motion"])
    jw.movement_enc, jw.text_enc, jw.motion_enc = map(
        _Jitted, (jw.movement_enc, jw.text_enc, jw.motion_enc))
    return jw


def _batch(rng, B, Tm, m_lens, cap_lens, L=22):
    return (rng.normal(size=(B, L, 300)).astype(np.float32),
            np.eye(15, dtype=np.float32)[rng.integers(0, 15, (B, L))],
            np.array(cap_lens), rng.normal(size=(B, Tm, 263)).astype(np.float32),
            np.array(m_lens))


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """Narrow widths, B = 3 + 1, T = 32: unsorted lengths with the full one;
    row 3 is row 1 with junk past its length (16) and the convolutions'
    halo (frames 24-31)."""
    w = _narrow_port_wrapper()
    path = _crossing(tmp_path_factory.mktemp("narrow"), w, 28)
    words, pos, cap, mot, ml = _batch(np.random.default_rng(1), 4, 32, [32, 16, 24, 16],
                                      [9, 22, 5, 22])
    mot[3], words[3], pos[3] = mot[1], words[1], pos[1]
    mot[3, 24:] = 999.0
    batch = (words, pos, cap, mot, ml)
    jw = _jax_wrapper(path, narrow=True)
    return path, batch, jw.get_co_embeddings(*batch), jw


def test_checkpoint_loads_strictly_with_the_reference_keys(narrow):
    path = narrow[0]
    state = load_torch_checkpoint(path)
    assert sorted(state) == ["motion_encoder", "movement_encoder", "text_encoder"]
    assert sorted(state["movement_encoder"]) == sorted(
        f"{m}.{p}" for m in ("main.0", "main.3", "out_net") for p in ("weight", "bias"))
    gru = [f"gru.{p}_l0{s}" for p in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
           for s in ("", "_reverse")]
    head = [f"{m}.{p}" for m in ("input_emb", "output_net.0", "output_net.1", "output_net.3")
            for p in ("weight", "bias")]
    assert sorted(state["motion_encoder"]) == sorted(gru + head + ["hidden"])
    assert sorted(state["text_encoder"]) == sorted(gru + head + ["hidden", "pos_emb.weight",
                                                                  "pos_emb.bias"])
    assert state["text_encoder"]["hidden"].shape == (2, 1, NARROW["text"][0])
    w = _narrow_port_wrapper()
    w.load_state_dict(state)
    for key, sd in w.state_dict().items():
        for k, v in sd.items():
            assert torch.equal(v, state[key][k]), (key, k)


def test_modules_match_jax_at_narrow_widths(narrow):
    """Each module alone, on the narrow batch, against JAX's on the same
    file's weights."""
    path, (words, pos, cap, mot, ml), _, jw = narrow
    w = _narrow_port_wrapper()
    w.load_state_dict(load_torch_checkpoint(path))
    v = jw.variables
    with torch.no_grad():
        mov = w.movement_enc(torch.from_numpy(mot[..., :-4]))
        _close(mov, jw.movement_enc.apply(v["movement"], mot[..., :-4]), rel=1e-5)
        mlen = ml // 4
        _close(w.motion_enc(mov, torch.from_numpy(mlen)),
               jw.motion_enc.apply(v["motion"], mov.numpy(), mlen), rel=1e-5)
        _close(w.text_enc(torch.from_numpy(words), torch.from_numpy(pos), torch.from_numpy(cap)),
               jw.text_enc.apply(v["text"], words, pos, cap), rel=1e-5)


def test_co_embeddings_match_jax_at_narrow_widths(narrow):
    """The wrapper, unsorted lengths, input order kept; junk past a clip's
    length and the halo leaves its embedding as it was."""
    path, batch, (jt, jm), _ = narrow
    w = _narrow_port_wrapper()
    w.load_state_dict(load_torch_checkpoint(path))
    t, m = w.get_co_embeddings(*batch)
    _close(t, jt, rel=1e-5)
    _close(m, jm, rel=1e-5)
    np.testing.assert_allclose(m[3], m[1], atol=1e-5 * np.abs(m).max())
    np.testing.assert_allclose(t[3], t[1], atol=1e-5 * np.abs(t).max())
    _close(w.get_motion_embeddings(batch[3], batch[4]), m, atol=0.0)


def test_plain_gru_matches_cudnn_path(narrow):
    """`bigru_co_plain` (`gru_plain`, the version the card's cuDNN GRU is
    held against, in place of ``nn.GRU`` over the packed sequence) within
    1e-5 of the largest value, on the CPU."""
    path, (words, pos, cap, mot, ml), _, _ = narrow
    w = _narrow_port_wrapper()
    w.load_state_dict(load_torch_checkpoint(path))
    x = torch.from_numpy(words), torch.from_numpy(pos), torch.from_numpy(cap)
    with torch.no_grad():
        te = w.text_enc
        _close(bigru_co_plain(te, te.input_emb(x[0] + te.pos_emb(x[1])), x[2]), te(*x),
               rel=1e-5)
        mov = w.movement_enc(torch.from_numpy(mot[..., :-4]))
        mlen = torch.from_numpy(ml // 4)
        me = w.motion_enc
        _close(bigru_co_plain(me, me.input_emb(mov), mlen), me(mov, mlen), rel=1e-5)
        gru = torch.nn.GRU(8, 6, batch_first=True)  # one direction, zero initial state
        seq = torch.randn(3, 5, 8, generator=torch.Generator().manual_seed(0))
        _close(gru_plain(gru, seq), gru(seq)[1], atol=1e-6)


def test_wrapper_matches_jax_at_published_widths(tmp_path):
    """512 / 1024 at B = 2, T = 16, HumanML3D's 22-token captions, on the
    reference's initialisation (the narrow cases move every parameter)."""
    w = T2MEvaluatorWrapper("t2m", device="cpu")
    path = _crossing(tmp_path, w, 7, noise=False)
    batch = _batch(np.random.default_rng(2), 2, 16, [8, 16], [22, 7])
    got = T2MEvaluatorWrapper("t2m", load_torch_checkpoint(path), device="cpu")
    t, m = got.get_co_embeddings(*batch)
    jt, jm = _jax_wrapper(path, narrow=False).get_co_embeddings(*batch)
    assert t.shape == m.shape == (2, 512)
    _close(t, jt, rel=1e-5)
    _close(m, jm, rel=1e-5)


@pytest.mark.parametrize("name,dim_pose", [("t2m", 263), ("kit", 251)])
def test_wrapper_datasets(name, dim_pose):
    w = T2MEvaluatorWrapper(name, device="cpu")
    assert w.dim_pose == dim_pose and w.movement_enc.main[0].in_channels == dim_pose - 4


def test_wrapper_raises_for_music_dataset():
    with pytest.raises(KeyError):
        T2MEvaluatorWrapper("ConductorMotion100", device="cpu")


def test_init_is_the_generators():
    """One seed gives one set of weights; another seed another."""
    a, b, c = (_narrow_port_wrapper().init(torch.Generator().manual_seed(s)) for s in (3, 3, 4))
    key = ("motion_encoder", "gru.weight_hh_l0")
    assert all(torch.equal(a[k][n], b[k][n]) for k in a for n in a[k])
    assert not torch.equal(a[key[0]][key[1]], c[key[0]][key[1]])
    assert torch.all(a["text_encoder"]["input_emb.bias"] == 0)


# ------------------------------------------------- vectorizer and dataset

VOCAB = ["unk", "sos", "eos", "a", "person", "walks", "walk", "left", "slowly", "chair", "arm",
         "jumps", "forward", "the", "then"]


@pytest.fixture
def glove(tmp_path):
    rng = np.random.default_rng(4)
    root = tmp_path / "glove"
    root.mkdir()
    order = list(rng.permutation(len(VOCAB)))
    np.save(root / "our_vab_data.npy", rng.normal(size=(len(VOCAB), 300)).astype(np.float32))
    with open(root / "our_vab_words.pkl", "wb") as f:
        pickle.dump(VOCAB, f)
    with open(root / "our_vab_idx.pkl", "wb") as f:
        pickle.dump({w: int(order[i]) for i, w in enumerate(VOCAB)}, f)
    return str(root)


def test_word_vectorizer_matches_jax(glove):
    got = word_vectorizer.WordVectorizer(glove, "our_vab")
    want = jax_wv.WordVectorizer(glove, "our_vab")
    assert len(got) == len(want) == len(VOCAB)
    assert word_vectorizer.POS_ENUMERATOR == jax_wv.POS_ENUMERATOR
    for item in ["walk/VERB", "person/NOUN", "left/ADV", "slowly/ADV", "chair/NOUN", "arm/NOUN",
                 "the/DET", "zebra/NOUN", "sos/OTHER", "jumps/XYZ"]:
        for g, w in zip(got[item], want[item]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    with pytest.raises(FileNotFoundError):
        word_vectorizer.WordVectorizer(glove, "missing")


def _t2m_folders(tmp_path):
    motion_dir, text_dir = tmp_path / "joints", tmp_path / "texts"
    motion_dir.mkdir()
    text_dir.mkdir()
    rng = np.random.default_rng(6)
    lines = {
        "m1": "a person walks#a/DET person/NOUN walks/VERB#0.0#0.0\n"
              "walk left#walk/VERB left/ADV#0.5#3.5\nthen#then/ADV#nan#nan\n",
        "m2": "jumps forward slowly#jumps/VERB forward/ADV slowly/ADV#0.0#0.0\n"
              "the chair#the/DET chair/NOUN#1.0#4.0\nbad line\n",
        "m3": "many walks#" + " ".join(["walk/VERB"] * 25) + "#0.0#0.0\n",  # > max_text_len
        "m4": "arm#arm/NOUN#0.0#0.0\n",
        "short": "walk#walk/VERB#0.0#0.0\n",
    }
    for name, n in [("m1", 120), ("m2", 90), ("m3", 60), ("m4", 199), ("short", 20)]:
        np.save(motion_dir / f"{name}.npy", rng.normal(size=(n, 263)).astype(np.float32))
        (text_dir / f"{name}.txt").write_text(lines[name])
    (tmp_path / "split.txt").write_text("m1\nm2\nm3\nm4\nshort\nmissing\n")
    return str(motion_dir), str(text_dir), str(tmp_path / "split.txt")


@pytest.mark.parametrize("vectorized", [True, False])
def test_text2motion_dataset_matches_jax(tmp_path, glove, vectorized):
    """Every item of 3 epochs bit for bit, sub-clips and their random names
    included, with the same seed."""
    folders = _t2m_folders(tmp_path)
    rng = np.random.default_rng(8)
    mean, std = rng.normal(size=263).astype(np.float32), rng.uniform(0.5, 2, 263).astype(np.float32)
    kw = dict(times=3, seed=5)
    got = dataset.Text2MotionDataset(*folders, mean, std, **kw, w_vectorizer=(
        word_vectorizer.WordVectorizer(glove, "our_vab") if vectorized else None))
    want = jax_dataset.Text2MotionDataset(*folders, mean, std, **kw, w_vectorizer=(
        jax_wv.WordVectorizer(glove, "our_vab") if vectorized else None))
    assert got.name_list == want.name_list and len(got) == len(want) == 3 * len(got.name_list)
    assert any(n[1] == "_" for n in got.name_list)  # a sub-clip's random name
    for i in range(len(got)):
        for g, w in zip(got[i], want[i]):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
            else:
                assert g == w
    np.testing.assert_array_equal(got.inv_transform(got[0][-3 if vectorized else 1]),
                                  want.inv_transform(want[0][-3 if vectorized else 1]))


# --------------------------------------------------------------- plotting

def test_plot_3d_raises_without_matplotlib(monkeypatch, tmp_path):
    for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.animation"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        plot_3d.plot_3d_motion(str(tmp_path / "x.gif"), param_util.t2m_kinematic_chain,
                               np.zeros((2, J, 3), np.float32))


def test_plot_3d_renders_a_gif(tmp_path):
    """Two frames through the current matplotlib (Agg, Pillow's gif writer)."""
    from PIL import Image

    joints = np.random.default_rng(9).normal(size=(2, J, 3)).astype(np.float32)
    path = plot_3d.plot_3d_motion(str(tmp_path / "x.gif"), param_util.t2m_kinematic_chain,
                                  joints, title="walk", figsize=(2, 2), fps=10)
    with Image.open(path) as im:
        assert im.n_frames == 2 and im.size == (200, 200)
