"""Mean completion time over the measured requests, from the due time to
the return of the step() that emitted the last token (a failed request
counts the time it had waited when the run stopped)."""

import stats


def read(rec):
    if not rec.requests:
        return None
    return stats.mean([d for _, d, _ in rec.requests],
                      [w for _, _, w in rec.requests])
