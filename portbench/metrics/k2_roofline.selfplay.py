"""K2's share of its roofline over the traced window: the least time
of every call (roofline.k2_bytes and k2_ops from the boards labelled)
over the summed device time of its kernel (labels_kernel), in %."""

from portbench import roofline as RF


def read(r):
    dev_s = r.trace.device_s(lambda n: "labels_kernel" in n)
    boards = r.counters.get("k2_boards", 0)
    if dev_s <= 0 or not boards:
        return None
    size = r.cfg["board_size"]
    return 100.0 * RF.bound_s(RF.k2_bytes(boards, size),
                              RF.k2_ops(boards, size)) / dev_s
