"""K1's share of its roofline over the traced window: the sum over its
calls of the least time the card could take (bytes from each call's
active lanes, roofline.k1_bytes) over the summed device time of its
kernel (chase_kernel in the profiler's events), in %."""

from portbench import roofline as RF


def read(r):
    dev_s = r.trace.device_s(lambda n: "chase_kernel" in n)
    calls = r.counters.get("k1_calls", [])
    if dev_s <= 0 or not calls:
        return None
    size = r.cfg["board_size"]
    bound = sum(RF.bound_s(RF.k1_bytes(int(active), lanes, size))
                for active, lanes in calls)
    return 100.0 * bound / dev_s
