"""Render engine (port of openal_soft_tpu/core): the device, its param
table, carried state and effect slots.  The host modules (context params,
voices, panning, HRTF loading, mastering) are copies of the reference's."""
