"""ssd_share.granite: the device time of the SSD scan family's kernels
(families/ssd_scan.json) as a % of the profiled window's busy time; None
where none of them ran."""


def read(reading):
    t = reading.trace
    fams = reading.spec.families()
    if t is None or "ssd_scan" not in fams or t.busy_s <= 0:
        return None
    secs = t.family_seconds(fams["ssd_scan"]["patterns"])
    return 100.0 * secs / t.busy_s if secs > 0 else None
