"""A reference run directory's ``opt.txt``, and its checkpoint.

The port's copy of `conductor_tpu/interop/opt_txt.py` (it imports nothing
of the JAX package).  The reference's rank 0 writes every option as ``key:
value`` lines to ``checkpoints/<dataset>/<name>/opt.txt``
(`options/base_options.py:72-89`) and its tools parse it back with typed
coercion (`utils/get_opt.py:29-106`); the checkpoints lie beside it in
``model/`` (``latest.tar``, ``ckpt_e%03d.tar``,
`trainers/ddpm_trainer.py:329,363-369`).

`read_opt_txt` coerces as the reference does (the words True / False,
decimal floats, digit strings as ints, anything else a string), and also
reads ``None`` and scientific notation, which the reference's float rule
misses although ``str(2e-05)`` is how a small learning rate lands in the
file.  `resolve_run_dir` maps a run directory to its (options,
checkpoint path), which ``cli.import_torch diffusion`` reads.
"""

from __future__ import annotations

import os
import re

_FLOAT_RE = re.compile(r"^[-+]?[0-9]+\.[0-9]+$")
_SCI_RE = re.compile(r"^[-+]?[0-9](\.[0-9]+)?e[-+]?[0-9]+$")
_SKIP = ("------------ Options -------------", "-------------- End ----------------")


def _coerce(value: str):
    if value == "True":
        return True
    if value == "False":
        return False
    if value == "None":
        return None
    if _FLOAT_RE.match(value) or _SCI_RE.match(value):
        return float(value)
    if value.lstrip("-+").isdigit():
        return int(value)
    return value


def read_opt_txt(path: str) -> dict:
    """An opt.txt as a typed dict (`utils/get_opt.py:36-49`); a value may
    itself hold ``": "`` (the line splits at the first)."""
    out: dict = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line in _SKIP or ": " not in line:
                continue
            key, value = line.split(": ", 1)
            out[key] = _coerce(value)
    return out


def write_opt_txt(path: str, opt: dict) -> None:
    """Write ``opt`` in the reference's layout (`options/base_options.py:
    72-89`): the two banner lines around one ``key: value`` line each."""
    with open(path, "w") as f:
        f.write(_SKIP[0] + "\n")
        for key, value in opt.items():
            f.write(f"{key}: {value}\n")
        f.write(_SKIP[1] + "\n")


def resolve_run_dir(path: str, which_epoch: str = "latest") -> tuple[dict, str]:
    """A reference run directory -> (its options, its checkpoint's path).
    ``which_epoch`` is "latest" or an epoch number (the reference's
    ``--which_epoch``; epoch checkpoints are ``model/ckpt_e%03d.tar``)."""
    opt_path = os.path.join(path, "opt.txt")
    if not os.path.isfile(opt_path):
        raise FileNotFoundError(
            f"{path} is a directory but has no opt.txt — pass the tar file "
            "directly, or point at a reference run dir "
            "(checkpoints/<dataset>/<name>/)"
        )
    opt = read_opt_txt(opt_path)
    name = "latest.tar" if which_epoch == "latest" else "ckpt_e%03d.tar" % int(which_epoch)
    tar = os.path.join(path, "model", name)
    if not os.path.isfile(tar):
        raise FileNotFoundError(f"no checkpoint at {tar}")
    return opt, tar
