"""Multi-card scaling: voice-axis sharding over a torch.distributed group."""

from .sharding import (VOICE_AXIS, device_step_inputs, dryrun_multichip,
                       gather_voices, make_sharded_device_step, shard_inputs)

__all__ = ["VOICE_AXIS", "device_step_inputs", "dryrun_multichip",
           "gather_voices", "make_sharded_device_step", "shard_inputs"]
