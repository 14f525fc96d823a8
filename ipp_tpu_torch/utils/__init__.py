"""Host utilities of the port: device and precision policy, transfers,
and copies of ipp_tpu/utils iostat, lagged, log, memory and progress; the
marker and SWC utilities (markers.py, reconops.py), whose tables are
numpy structured arrays read and written by csvtable.py, not pandas."""
