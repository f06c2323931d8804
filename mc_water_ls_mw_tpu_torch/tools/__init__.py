"""The run's own tools, without JAX: each module runs as
``python -m mc_water_ls_mw_tpu_torch.tools.<name>`` and exposes
``main(argv=None)``.

* ``watchdog``: supervise a run, relaunch it on a hang or a crash
  behind a probe of the card (liveness.py);
* ``threebody_filter``: the weight of the near-collinear three-body
  terms the reference's local energy drops, on sampled states;
* ``deltag_error``: Delta G with a block-jackknife error bar from a
  sample run's dumps (mw and 'dd');
* ``deltag_from_weights``: the weights-direct Delta G series over a
  Wang-Landau run's f-archives;
* ``retarget_weights``: converged weights re-gridded onto another mu
  grid;
* ``compare_dd_mw``: a 'dd' stitched weight curve against an 'mw' one.

The analysis tools are numpy and touch no device.
"""
