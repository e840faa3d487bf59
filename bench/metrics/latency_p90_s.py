"""90th percentile of the completion times of the measured requests,
failures ranked last."""

import stats


def read(rec):
    if not rec.requests:
        return None
    return stats.tail([d for _, d, _ in rec.requests],
                      [w for _, _, w in rec.requests], 90)
