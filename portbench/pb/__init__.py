"""The benchmark harness of graspldm_tpu_torch (see ``portbench/run.py``)."""
