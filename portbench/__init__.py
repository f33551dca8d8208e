"""The benchmark of ``spatial_audio_framework_tpu_torch``, the PyTorch and
CUDA package: ``python3 portbench/run.py --workload <config>.<mix> --seed
<n> --seconds <s> --trace <0|1>`` (``portbench/run.py``)."""
