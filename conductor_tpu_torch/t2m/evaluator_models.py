"""The T2M co-embedding evaluator networks (reference
`datasets/evaluator_models.py:79-438`, `datasets/evaluator.py:354-441`;
the port of `conductor_tpu/t2m/evaluator_models.py`).

The modules carry the reference's key names (``main.0`` / ``main.3`` /
``out_net``; ``pos_emb``, ``input_emb``, ``hidden`` (2, 1, H), ``gru.*_l0``
and ``gru.*_l0_reverse``, ``output_net.{0,1,3}``), so the published
`text_mot_match/.../finest.tar` (``{"movement_encoder", "text_encoder",
"motion_encoder"}``) loads strictly with no mapping
(`load_torch_checkpoint`); `save_torch_checkpoint` writes that layout.
The GRUs are torch's two-bias `nn.GRU`, run over a packed sequence with
``enforce_sorted=False``: the backward direction starts at each clip's
last valid frame and the embeddings stay in input order, as JAX's
(`nn.RNN(seq_lengths=...)`) do; the reference's sorted output is what JAX
dropped on purpose.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from ..models.generator import gru_plain
from ..models.precision import full_float32
from ..train.ddpm_trainer import require_device

# checkpoint key -> the wrapper's attribute
_CKPT_KEYS = {"movement_encoder": "movement_enc", "text_encoder": "text_enc",
              "motion_encoder": "motion_enc"}


class MovementConvEncoder(nn.Module):
    """Two Conv1d (k 4, stride 2, pad 1), each followed by dropout and
    LeakyReLU(0.2), and a linear head: pose frames (B, T, input_size) ->
    movement latents (B, T / 4, output_size) (`evaluator_models.py:79-98`)."""

    def __init__(self, input_size: int, hidden_size: int = 512, output_size: int = 512,
                 dropout: float = 0.2):
        super().__init__()
        self.main = nn.Sequential(
            nn.Conv1d(input_size, hidden_size, 4, 2, 1), nn.Dropout(dropout), nn.LeakyReLU(0.2),
            nn.Conv1d(hidden_size, output_size, 4, 2, 1), nn.Dropout(dropout), nn.LeakyReLU(0.2))
        self.out_net = nn.Linear(output_size, output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_net(self.main(x.transpose(1, 2)).transpose(1, 2))


class _BiGRUCo(nn.Module):
    """The shared trunk: ``input_emb``, a bidirectional GRU from the learned
    initial state ``hidden``, the two directions' last states through
    ``output_net`` (Linear, LayerNorm eps 1e-5, LeakyReLU(0.2), Linear)."""

    def __init__(self, input_size: int, hidden_size: int, output_size: int):
        super().__init__()
        self.input_emb = nn.Linear(input_size, hidden_size)
        self.gru = nn.GRU(hidden_size, hidden_size, batch_first=True, bidirectional=True)
        self.output_net = nn.Sequential(
            nn.Linear(hidden_size * 2, hidden_size), nn.LayerNorm(hidden_size),
            nn.LeakyReLU(0.2), nn.Linear(hidden_size, output_size))
        self.hidden = nn.Parameter(torch.randn(2, 1, hidden_size))

    def trunk(self, inputs: torch.Tensor, lengths) -> torch.Tensor:
        h0 = self.hidden.repeat(1, inputs.shape[0], 1)
        packed = pack_padded_sequence(inputs, torch.as_tensor(lengths).cpu(),
                                      batch_first=True, enforce_sorted=False)
        _, last = self.gru(packed, h0.contiguous())
        return self.output_net(torch.cat([last[0], last[1]], dim=-1))


class TextEncoderBiGRUCo(_BiGRUCo):
    """GloVe vectors plus embedded POS one-hots -> a sentence co-embedding
    (`evaluator_models.py:311-350`)."""

    def __init__(self, word_size: int = 300, pos_size: int = 15, hidden_size: int = 512,
                 output_size: int = 512):
        super().__init__(word_size, hidden_size, output_size)
        self.pos_emb = nn.Linear(pos_size, word_size)

    def forward(self, word_embs, pos_onehot, cap_lens) -> torch.Tensor:
        return self.trunk(self.input_emb(word_embs + self.pos_emb(pos_onehot)), cap_lens)


class MotionEncoderBiGRUCo(_BiGRUCo):
    """Movement latents -> a motion co-embedding
    (`evaluator_models.py:353-386`)."""

    def __init__(self, input_size: int = 512, hidden_size: int = 1024, output_size: int = 512):
        super().__init__(input_size, hidden_size, output_size)

    def forward(self, movements, m_lens) -> torch.Tensor:
        return self.trunk(self.input_emb(movements), m_lens)


def bigru_co_plain(enc: _BiGRUCo, inputs: torch.Tensor, lengths) -> torch.Tensor:
    """``enc``'s trunk on its embedded ``inputs`` (``enc.input_emb(...)``)
    with `gru_plain` in place of cuDNN's GRU: the version the encoders'
    GRUs are held against."""
    h0 = enc.hidden.repeat(1, inputs.shape[0], 1)
    last = gru_plain(enc.gru, inputs, torch.as_tensor(lengths), h0)
    return enc.output_net(torch.cat([last[0], last[1]], dim=-1))


def _init_reference(module: nn.Module, generator: torch.Generator) -> None:
    """Draw ``module``'s parameters from ``generator`` by the reference's
    rule: Conv1d and Linear weights Xavier-normal with zero biases
    (`evaluator_models.py` ``init_weight``), GRU parameters uniform in
    +-1/sqrt(H) (torch's own rule), LayerNorm 1 and 0, ``hidden`` standard
    normal.  Drawn on the CPU, so one seed gives the same weights on every
    device."""
    def put(p: torch.Tensor, value: torch.Tensor) -> None:
        with torch.no_grad():
            p.copy_(value)

    for m in module.modules():
        if isinstance(m, (nn.Conv1d, nn.Linear)):
            fan_in = m.weight.shape[1] * m.weight[0, 0].numel()
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            std = math.sqrt(2.0 / (fan_in + fan_out))
            put(m.weight, torch.randn(m.weight.shape, generator=generator) * std)
            put(m.bias, torch.zeros(m.bias.shape))
        elif isinstance(m, nn.GRU):
            bound = 1.0 / math.sqrt(m.hidden_size)
            for p in m.parameters():
                put(p, (torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
        elif isinstance(m, nn.LayerNorm):
            put(m.weight, torch.ones(m.weight.shape))
            put(m.bias, torch.zeros(m.bias.shape))
        if isinstance(m, _BiGRUCo):
            put(m.hidden, torch.randn(m.hidden.shape, generator=generator))


class T2MEvaluatorWrapper:
    """`EvaluatorModelWrapper` (`evaluator.py:375-441`) at the published
    widths: strips the 4 foot-contact channels, movement-encodes at
    unit_length 4 over the whole padded window, then co-embeds the first
    ``m_lens // 4`` latents.  Raises `KeyError` for any dataset but t2m /
    kit, as the reference does (`evaluator.py:281-293`); ConductorMotion100
    uses `eval.protocol.M2SNetCoEmbedding`.

    Runs on ``device`` (the card unless the caller asks for the CPU; it
    raises without one), with TF32 off.  ``state`` is a `finest.tar`-layout
    dict (`load_torch_checkpoint`), loaded strictly; without it the weights
    are torch's default draws until `init` or `load_state_dict`."""

    UNIT_LENGTH = 4

    def __init__(self, dataset_name: str, state: dict | None = None,
                 device: torch.device | str = "cuda"):
        if dataset_name == "t2m":
            self.dim_pose = 263
        elif dataset_name == "kit":
            self.dim_pose = 251
        else:
            raise KeyError(
                "Dataset not Recognized!!! (t2m/kit only; music uses M2SNetCoEmbedding)")
        self.device = require_device(device)
        self.movement_enc = MovementConvEncoder(self.dim_pose - 4).to(self.device).eval()
        self.text_enc = TextEncoderBiGRUCo().to(self.device).eval()
        self.motion_enc = MotionEncoderBiGRUCo().to(self.device).eval()
        if state is not None:
            self.load_state_dict(state)

    def init(self, generator: torch.Generator) -> dict:
        """Every parameter drawn from ``generator`` (`_init_reference`), as
        JAX's ``init(rng)``; returns the `finest.tar`-layout state."""
        for key, attr in _CKPT_KEYS.items():
            _init_reference(getattr(self, attr), generator)
        return self.state_dict()

    def state_dict(self) -> dict:
        return {key: getattr(self, attr).state_dict() for key, attr in _CKPT_KEYS.items()}

    def load_state_dict(self, state: dict) -> None:
        for key, attr in _CKPT_KEYS.items():
            getattr(self, attr).load_state_dict(state[key], strict=True)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def get_motion_embeddings(self, motions, m_lens) -> np.ndarray:
        """motions (B, T, dim_pose), m_lens (B,) -> (B, 512), in input order."""
        with full_float32():
            movements = self.movement_enc(self._tensor(motions)[..., :-4])
            m_lens = torch.as_tensor(m_lens) // self.UNIT_LENGTH
            return self.motion_enc(movements, m_lens).cpu().numpy()

    @torch.no_grad()
    def get_co_embeddings(self, word_embs, pos_ohot, cap_lens, motions, m_lens):
        """-> (text embeddings (B, 512), motion embeddings (B, 512))."""
        with full_float32():
            text_emb = self.text_enc(self._tensor(word_embs), self._tensor(pos_ohot),
                                     torch.as_tensor(cap_lens)).cpu().numpy()
        return text_emb, self.get_motion_embeddings(motions, m_lens)


def load_torch_checkpoint(path: str) -> dict:
    """The reference's `finest.tar` -> ``{"movement_encoder",
    "text_encoder", "motion_encoder"}`` state dicts on the CPU, for
    `T2MEvaluatorWrapper` (`evaluator.py:367-372`)."""
    ckpt = torch.load(path, map_location="cpu")
    return {key: ckpt[key] for key in _CKPT_KEYS}


def save_torch_checkpoint(path: str, state: dict) -> None:
    """Write ``state`` (`T2MEvaluatorWrapper.state_dict`) as a
    `finest.tar`-layout file, which the reference's evaluator and JAX's
    ``load_torch_checkpoint`` read."""
    torch.save({key: {k: v.detach().cpu() for k, v in state[key].items()} for key in _CKPT_KEYS},
               path)
