"""Multi-device execution of the port: the ('stream', 'tile') mesh, the
per-shard kernel dispatch, the sharded pipeline and its multi-process
launcher (counterpart of stereovision_tpu/parallel/)."""
