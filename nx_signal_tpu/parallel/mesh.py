"""Device mesh construction for the DSP sharding layer.

The framework's two parallelism axes (SURVEY.md §2.9 — greenfield, the
reference is single-device):

* 'channel' — embarrassingly-parallel data parallelism over independent
  signal channels (leading batch axis).
* 'block'   — time-block sequence parallelism: contiguous stream blocks per
  device, with K-1 overlap-save filter tails / STFT frame tails / OLA frame
  tails exchanged between neighbors via jax.lax.ppermute (neighbor
  traffic, never all-to-all).

In a multi-host job, jax.make_mesh orders devices so that the trailing
mesh axis maps to the cards of one host — put 'block' last so halo
exchange stays on NVLink while 'channel' (no communication) spans hosts.
"""

import jax
from jax.sharding import AxisType, NamedSharding, PartitionSpec

CHANNEL_AXIS = "channel"
BLOCK_AXIS = "block"

__all__ = ["make_dsp_mesh", "channel_block_sharding", "CHANNEL_AXIS", "BLOCK_AXIS"]


def make_dsp_mesh(n_channel: int = 1, n_block: int = None, *, devices=None):
    """Build a ('channel', 'block') mesh. By default all (or the given)
    devices go on the 'block' axis.

    Examples:

    >>> from nx_signal_tpu.parallel.mesh import make_dsp_mesh
    >>> mesh = make_dsp_mesh(2, 4)   # 2-way channel DP x 4-way time-block SP
    >>> dict(mesh.shape)
    {'channel': 2, 'block': 4}
    """
    n_devices = len(devices) if devices is not None else jax.device_count()
    if n_block is None:
        n_block = n_devices // n_channel
    if n_channel * n_block != n_devices:
        raise ValueError(
            f"mesh shape ({n_channel}, {n_block}) does not match {n_devices} devices"
        )
    return jax.make_mesh(
        (n_channel, n_block),
        (CHANNEL_AXIS, BLOCK_AXIS),
        axis_types=(AxisType.Auto, AxisType.Auto),
        devices=devices,
    )


def channel_block_sharding(mesh, *, ndim: int = 2):
    """NamedSharding placing the leading axis on 'channel' and the trailing
    (time) axis on 'block'; middle axes replicated.

    Examples:

    >>> from nx_signal_tpu.parallel.mesh import channel_block_sharding, make_dsp_mesh
    >>> sh = channel_block_sharding(make_dsp_mesh(2, 4), ndim=2)
    >>> sh.spec
    PartitionSpec('channel', 'block')
    """
    spec = [None] * ndim
    if ndim >= 2:
        spec[0] = CHANNEL_AXIS
    spec[-1] = BLOCK_AXIS
    return NamedSharding(mesh, PartitionSpec(*spec))
