"""paddle_tpu_torch.tensor — the tensor op namespace (reference:
python/paddle/tensor/), port of ``paddle_tpu/tensor``: creation, math,
manipulation, linalg, logic, inplace, random, stat and the tensor array,
each a plain function on ``torch.Tensor``s. The package's top level
exports every name, as ``paddle.add`` is exported."""
from . import (array, creation, inplace, linalg, logic, manipulation, math,  # noqa: F401
               random, stat)
from .array import array_length, array_read, array_write, create_array  # noqa: F401
from .inplace import *  # noqa: F401,F403
from .creation import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .stat import (  # noqa: F401
    median, nanmean, nanmedian, nanquantile, nansum, quantile, std, var)

__all__ = sorted(set(
    array.__all__ + inplace.__all__ + creation.__all__ + linalg.__all__
    + logic.__all__ + manipulation.__all__ + math.__all__ + random.__all__
    + ["median", "nanmean", "nanmedian", "nanquantile", "nansum",
       "quantile", "std", "var"]))
