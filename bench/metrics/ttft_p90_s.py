"""90th percentile over the measured requests of the time from a request's
due time to the return of the step() that emitted its first token; a
failed request misses (it ranks after every finished one)."""

import stats


def read(rec):
    if not rec.requests:
        return None
    return stats.tail([t for t, _, _ in rec.requests],
                      [w for _, _, w in rec.requests], 90)
