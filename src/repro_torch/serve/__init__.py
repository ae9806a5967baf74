from repro_torch.serve.engine import ServeEngine, make_decode_block_step, \
    make_serve_step

__all__ = ["ServeEngine", "make_decode_block_step", "make_serve_step"]
