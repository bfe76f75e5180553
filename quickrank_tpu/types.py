"""Core scalar types and constants.

Counterpart of the reference's ``include/types.h:28-35``
(Label=float, Score=double, Feature=float, QueryID=uint, MetricScore=double).
The device compute dtype is float32; metric
accumulation stays float32 on device and float64 on host where it matters.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# Host-side dtypes (numpy)
LABEL_DTYPE = np.float32
FEATURE_DTYPE = np.float32
SCORE_DTYPE = np.float32
QID_DTYPE = np.int64

# Device-side dtypes
F32 = jnp.float32
I32 = jnp.int32
U8 = jnp.uint8
U16 = jnp.uint16

# Sentinel used in padded gather maps and node ids.
INVALID = -1

# "No cutoff" sentinel mirroring metric.h's NO_CUTOFF (2^31-1 effectively
# "use the whole list").
NO_CUTOFF = 1 << 30
