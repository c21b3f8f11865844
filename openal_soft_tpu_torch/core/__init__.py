"""Render engine (port of openal_soft_tpu/core): the device, its param
table and carried state.  The reference's host modules in ``core``
(context params, voices, panning, HRTF loading, mastering) are shared."""
