"""Multi-process and multi-device work on ``torch.distributed``: the port
of ``fractalshark_tpu/parallel/``.  A mesh is a process group with one
rank per device (``mesh``); over it ``ntt_sharded`` spreads one bignum
transform (K8 on each rank), ``orbit_sharded`` one orbit step (K8 and the
sharded tail K20) and the device orbit's session, ``render`` and
``stream_render`` the pixel rows of a frame (K1, K6, K3); ``tile_farm``
is the checkpointed tile queue of a render across processes and its
gather."""
