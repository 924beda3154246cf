"""Checkpoint/resume for streaming carry state (SURVEY.md §5 "Checkpoint").

The streaming processors (parallel/streaming.py) carry their entire stream
summary as an explicit pytree of arrays, so elastic recovery reduces to
serializing that pytree at a block boundary and restoring it in a fresh
process. The reference has no streaming and no checkpointing — this is the
This framework's equivalent of the orbax-based plan in SURVEY.md:332, built on
numpy's npz container (dependency-free, deterministic bytes for a given
state; orbax would add async/multihost sharding we don't need for carries
that are a few KB).

Format: one .npz with the flattened pytree leaves as `leaf_<i>` arrays, the
pytree structure as a pickled treedef, and a JSON `meta` dict (step counter,
user tags). Writes are atomic (tmp file + os.replace) so a crash mid-write
never corrupts the previous checkpoint.
"""

import io
import json
import os
import pickle

import jax
import numpy as np

__all__ = ["save_state", "load_state"]


def save_state(path, state, *, meta=None):
    """Atomically write the carry-state pytree (plus an optional JSON-able
    `meta` dict, e.g. {'step': n, 'sample_offset': n*chunk}) to `path`.

    Device arrays are pulled to host; sharded global arrays must be fully
    addressable (checkpoint per process, or gather first).
    
    Examples:

    >>> import tempfile, os
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.io.checkpoint import load_state, save_state
    >>> p = os.path.join(tempfile.mkdtemp(), 'state.npz')
    >>> save_state(p, {'zi': jnp.ones((2, 3)), 'step': 7}, meta={'offset': 640})
    >>> state, meta = load_state(p)
    >>> sorted(state), state['step'], meta
    (['step', 'zi'], array(7), {'offset': 640})
    """
    leaves, treedef = jax.tree_util.tree_flatten(state)
    payload = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    payload["treedef"] = np.frombuffer(
        pickle.dumps(treedef), dtype=np.uint8
    ).copy()
    payload["meta"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    ).copy()
    buf = io.BytesIO()
    np.savez(buf, **payload)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_state(path):
    """Restore (state_pytree, meta_dict) written by `save_state`. Leaves come
    back as numpy arrays — jnp ops consume them directly, and dtypes/values
    are bit-identical to what was saved.

    Examples:

    >>> import tempfile, os
    >>> import numpy as np
    >>> import jax.numpy as jnp
    >>> from nx_signal_tpu.io.checkpoint import load_state, save_state
    >>> p = os.path.join(tempfile.mkdtemp(), 'state.npz')
    >>> save_state(p, [jnp.arange(3.0)])
    >>> state, meta = load_state(p)
    >>> state[0], meta   # numpy back, bit-identical
    (array([0., 1., 2.], dtype=float32), {})
    """
    with np.load(path) as z:
        treedef = pickle.loads(z["treedef"].tobytes())
        meta = json.loads(z["meta"].tobytes().decode())
        n = len([k for k in z.files if k.startswith("leaf_")])
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    return jax.tree_util.tree_unflatten(treedef, leaves), meta
