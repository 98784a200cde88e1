"""95th percentile of the time to first token over every request of the
window: from when its batch was due to when its token is on the host, in
ms (numpy's linear percentile)."""

import numpy as np


def read(records):
    ttft = records.get("ttft_s")
    if not ttft:
        return None
    return 1e3 * float(np.percentile(ttft, 95))
