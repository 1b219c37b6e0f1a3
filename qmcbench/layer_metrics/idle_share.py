"""idle_share (%): 1 - the union of the device's operation intervals
over the traced waves' wall time (torch.profiler, CPU and CUDA
activity; the copy of ``chip_smoke.py``'s idle share)."""


def read(r):
    if r.device is None or r.device.window_s <= 0 or r.device.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)
