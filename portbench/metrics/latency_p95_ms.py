"""95th percentile over every call of the window of the host time from the
call of StereoEngine.run with host frames until its maps are back."""
import numpy as np


def read(rec):
    return float(np.percentile([c.host_ms for c in rec.calls], 95))
