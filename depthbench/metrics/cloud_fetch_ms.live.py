"""Transfers (transfer.py): process_frame's own timings["pc_t"], the
cloud's fetch to the host, mean ms a frame."""
UNIT, SOURCE, LAYER, MOVES = "ms", "program_span", "transfers", "frame_ms"


def read(rec):
    pc = rec.get("pc_t_s")
    if not pc:
        return None
    return 1e3 * sum(pc) / len(pc)
