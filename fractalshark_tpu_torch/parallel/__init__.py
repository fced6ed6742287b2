"""Multi-process and multi-device rendering on ``torch.distributed``: the
port of ``fractalshark_tpu/parallel/``.  ``tile_farm`` (the checkpointed
tile queue and its gather) is ported; ``render``, ``stream_render``,
``ntt_sharded`` and ``orbit_sharded`` are ROADMAP A6."""
