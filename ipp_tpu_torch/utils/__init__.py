"""Host utilities of the port: device and precision policy, transfers,
and copies of ipp_tpu/utils iostat, lagged, log, memory and progress."""
