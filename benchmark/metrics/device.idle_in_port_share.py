"""Percent of the device's idle time between consecutive composed
launches that lies under the program's own host spans (``graphs.STATS``
"spans", on the host's ``perf_counter_ns``, onto which the program maps
its launches' stamps): the port's part of the gaps; the rest is the
client's (its readback and its own code).  None where the program
records no spans or stamps."""


def read(rec):
    st = rec["stats"]
    launches = sorted((e["start_ns"], e["end_ns"])
                      for e in st.get("launches") or ())
    spans = sorted((s["start"], s["end"]) for s in st.get("spans") or ())
    if len(launches) < 2 or not spans:
        return None
    merged = [list(spans[0])]
    for a, b in spans[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    idle = under = 0
    j = 0
    for (_, end), (start, _) in zip(launches, launches[1:]):
        if start <= end:
            continue
        idle += start - end
        while j < len(merged) and merged[j][1] <= end:
            j += 1
        k = j
        while k < len(merged) and merged[k][0] < start:
            under += min(merged[k][1], start) - max(merged[k][0], end)
            k += 1
    return 100.0 * under / idle if idle else None
