"""Command-line tools of the port, each run as ``python -m
flexflow_tpu_torch.scripts.<name>``: ``costmodel`` (train and report the
learned cost model), ``calibrate`` (predicted against measured steps,
and ``--ingest-drift`` of traced runs, into ``CALIBRATION_GPU.json``),
``obs_report`` (a traced run's report), ``roofline`` (per-op roofline
and the NCHW/NHWC A/B), ``ckpt_inspect`` (a checkpoint's inventory and
integrity) and ``supervise`` (restart a training command on preemption).
They use the card unless asked for the CPU, and import nothing of JAX.
"""
