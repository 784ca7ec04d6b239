"""Checkpoint / resume for long-running fits.

A copy of ``singlet_tpu/checkpoint.py`` (numpy only, no device code), kept
here because the port imports nothing of ``singlet_tpu``. The file format
and the config fingerprints are the JAX package's, so a checkpoint written
by one package resumes in the other when the fit's geometry is the same.

The complete fit state (W, H, d, the iteration counter, the tol / test-MSE
traces and a config fingerprint) is written atomically every ``every``
iterations, and a resumed fit continues bit for bit: ALS is deterministic
given its state, and the test mask is a stateless counter hash of (seed,
cell, gene), so no RNG state is saved beyond the integer mask seed.

Storage is one ``.npz`` per checkpoint with a JSON ``__meta__`` entry;
writes go to a temporary file and ``os.replace``, so a crash mid-write
never corrupts the newest checkpoint. ``CheckpointManager`` keeps the
newest ``keep`` checkpoints of a directory and resolves the newest whose
fingerprint matches on resume; a mismatch (another k, penalty, mask seed or
data shape) starts fresh.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["save_fit_state", "load_fit_state", "CheckpointManager",
           "resolve_manager"]

_ARRAY_KEYS = ("W", "H", "d")


def save_fit_state(path: str, state: Dict[str, Any]) -> None:
    """Atomically write a fit-state dict to ``path`` (.npz): arrays under
    ``W``/``H``/``d`` (numpy), every other key through the JSON entry."""
    arrays = {k: np.asarray(state[k]) for k in _ARRAY_KEYS if k in state}
    meta = {k: v for k, v in state.items() if k not in _ARRAY_KEYS}
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta).encode(), dtype=np.uint8), **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_fit_state(path: str) -> Dict[str, Any]:
    """Inverse of :func:`save_fit_state`."""
    with np.load(path) as z:
        state: Dict[str, Any] = dict(
            json.loads(bytes(z["__meta__"].tobytes()).decode()))
        for k in _ARRAY_KEYS:
            if k in z:
                state[k] = z[k]
    return state


def _fingerprint(config: Dict[str, Any]) -> str:
    return json.dumps(config, sort_keys=True)


class CheckpointManager:
    """Directory of rolling fit checkpoints: ``ckpt_<iter>.npz``.

    ``every``: save cadence in iterations (0 or None disables the periodic
    saves; explicit ``save`` calls still work). ``keep``: how many of the
    newest checkpoints to retain (older ones are deleted after a successful
    save, never before).
    """

    def __init__(self, directory: str, every: int = 10, keep: int = 2) -> None:
        self.directory = directory
        self.every = int(every or 0)
        self.keep = max(int(keep), 1)

    def _path(self, it: int) -> str:
        return os.path.join(self.directory, f"ckpt_{it:08d}.npz")

    def _all(self) -> List[str]:
        return sorted(glob.glob(os.path.join(self.directory, "ckpt_*.npz")))

    def latest_path(self) -> Optional[str]:
        paths = self._all()
        return paths[-1] if paths else None

    def should_save(self, it: int) -> bool:
        """True when the cadence wants a save at this (1-based) iteration.
        Test it before copying device tensors to the host."""
        return bool(self.every) and it % self.every == 0

    def maybe_save(self, it: int, state: Dict[str, Any]) -> bool:
        """Save if the cadence says so (``it`` is the count of completed
        iterations)."""
        if self.should_save(it):
            self.save(it, state)
            return True
        return False

    def save(self, it: int, state: Dict[str, Any]) -> str:
        path = self._path(it)
        save_fit_state(path, dict(state, it=int(it)))
        for old in self._all()[: -self.keep]:
            try:
                os.unlink(old)
            except OSError:
                pass
        return path

    def restore(self, config: Dict[str, Any],
                verbose: bool = False) -> Optional[Dict[str, Any]]:
        """The newest checkpoint whose config fingerprint matches, or None
        (a fresh start) when there is none. ``config`` is the dict of
        :meth:`config_of` (or any dict, reduced to its fingerprint)."""
        want = config["config"] if set(config) == {"config"} \
            else _fingerprint(config)
        for path in reversed(self._all()):
            try:
                state = load_fit_state(path)
            except Exception:
                continue  # truncated or corrupt: atomic writes make it rare
            if state.get("config") == want:
                if verbose:
                    print(f"resuming from {path} (iter {state.get('it')})")
                return state
            if verbose:
                print(f"ignoring {path}: config fingerprint mismatch")
        return None

    @staticmethod
    def config_of(**kv: Any) -> Dict[str, Any]:
        """The fingerprint entry stored in every state."""
        return {"config": _fingerprint(kv)}


def resolve_manager(checkpoint, default_every: int = 10
                    ) -> Optional[CheckpointManager]:
    """The solvers take ``checkpoint`` as a CheckpointManager or a directory
    path; normalise it to a manager (or None)."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, CheckpointManager):
        return checkpoint
    return CheckpointManager(str(checkpoint), every=default_every)
