"""The port's reference-format weights as flax variables, for the modules
that JAX's `conductor_tpu.interop.torch_import` does not map: the BiLSTM
decoders (`PoseDecoderBiLSTM`, `Generator(decoder_kind="bilstm")`,
`GeneratorCVPRLSTM`), the Prospective `CNNLSTMGenerator` and a bare
`STGCN` (the "AE" mode).  JAX's own mappings do the rest (the music
encoder, the noise path, an ST-GCN's blocks).

A torch LSTM direction (``weight_ih`` / ``weight_hh`` rows in gate order
i, f, g, o, and two biases) becomes flax's `OptimizedLSTMCell`: input
kernels ``i{gate}`` without bias, hidden kernels ``h{gate}`` with the sum
of the two biases.  A bidirectional layer's forward cell comes before its
backward one, as flax names them in `nn.Bidirectional`.
"""

from __future__ import annotations

import numpy as np

from conductor_tpu.interop.torch_import import (
    _bn,
    _convtranspose1d,
    _dense,
    import_motion_encoder,
    import_music_encoder,
)


def as_numpy(sd) -> dict[str, np.ndarray]:
    return {k: np.array(v.detach().numpy() if hasattr(v, "detach") else v) for k, v in sd.items()}


def lstm_cell(sd, key: str, suffix: str = "") -> dict:
    """One direction of a one-layer ``nn.LSTM`` at ``key`` -> flax's
    `OptimizedLSTMCell` parameters."""
    w_ih = np.asarray(sd[f"{key}.weight_ih_l0{suffix}"], np.float32)
    w_hh = np.asarray(sd[f"{key}.weight_hh_l0{suffix}"], np.float32)
    bias = (np.asarray(sd[f"{key}.bias_ih_l0{suffix}"], np.float32)
            + np.asarray(sd[f"{key}.bias_hh_l0{suffix}"], np.float32))
    h = w_hh.shape[1]
    cell = {}
    for j, gate in enumerate("ifgo"):
        rows = slice(j * h, (j + 1) * h)
        cell[f"i{gate}"] = {"kernel": np.ascontiguousarray(w_ih[rows].T)}
        cell[f"h{gate}"] = {"kernel": np.ascontiguousarray(w_hh[rows].T), "bias": bias[rows]}
    return cell


def bilstm_decoder(sd, prefix: str = "", num_layers: int = 2) -> dict:
    """`PoseDecoderBiLSTM`'s parameters (``{prefix}lstm.{i}``,
    ``{prefix}fc.{0,2,4}``) -> flax's."""
    params = {}
    for i in range(num_layers):
        for j, suffix in enumerate(("", "_reverse")):
            params[f"OptimizedLSTMCell_{2 * i + j}"] = lstm_cell(sd, f"{prefix}lstm.{i}", suffix)
    for j, idx in enumerate((0, 2, 4)):
        params[f"Dense_{j}"] = _dense(sd, f"{prefix}fc.{idx}")
    return params


def generator_bilstm(sd) -> dict:
    """`Generator(decoder_kind="bilstm")` -> flax `Generator(decoder_kind=
    "bilstm")` variables."""
    music = import_music_encoder(sd, "music_encoder.")
    params = {"music_encoder": music["params"], "decoder": bilstm_decoder(sd, "lstm.")}
    for j, idx in enumerate((0, 2, 4, 6)):
        params[f"up{j + 1}"] = _convtranspose1d(sd, f"noise_convTranspose.{idx}")
    stats = {"music_encoder": music["batch_stats"]}
    params["noise_bn"], stats["noise_bn"] = _bn(sd, "noise_BN")
    return {"params": params, "batch_stats": stats}


def cvpr_lstm(sd) -> dict:
    """`GeneratorCVPRLSTM` -> flax's."""
    return {"params": {"PoseDecoderBiLSTM_0": bilstm_decoder(sd, "lstm.")}}


def cnn_lstm(sd) -> dict:
    """`CNNLSTMGenerator` -> flax's."""
    music = import_music_encoder(sd, "music_encoder.")
    return {"params": {"MusicEncoder_0": music["params"],
                       "OptimizedLSTMCell_0": lstm_cell(sd, "lstm"),
                       "Dense_0": _dense(sd, "fc.0"), "Dense_1": _dense(sd, "fc.2")},
            "batch_stats": {"MusicEncoder_0": music["batch_stats"]}}


def stgcn(sd) -> dict:
    """A bare `STGCN` (any mode) -> flax `STGCN` variables, through JAX's
    `import_motion_encoder` (given a placeholder projection)."""
    full = {f"st_gcn.{k}": v for k, v in sd.items()}
    width = np.asarray(sd["fcn.bias"]).shape[0] * np.asarray(sd["A"]).shape[1]
    full.update({"fc.0.weight": np.zeros((64, width, 1), np.float32),
                 "fc.0.bias": np.zeros(64, np.float32),
                 "fc.1.weight": np.ones(64, np.float32), "fc.1.bias": np.zeros(64, np.float32),
                 "fc.1.running_mean": np.zeros(64, np.float32),
                 "fc.1.running_var": np.ones(64, np.float32)})
    v = import_motion_encoder(full)
    return {"params": v["params"]["st_gcn"], "batch_stats": v["batch_stats"]["st_gcn"]}
