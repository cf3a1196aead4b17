"""Dataset corpora (``paddle.dataset``'s interface), the port's own copy
of ``paddle_tpu/datasets/``.

The reference package downloads nothing: each module synthesizes a
deterministic, learnable stand-in corpus with the same reader interface
(nullary callables yielding samples).  These copies yield the same
samples, array for array, from the same seeds.
"""

from . import cifar  # noqa: F401
from . import conll05  # noqa: F401
from . import flowers  # noqa: F401
from . import image  # noqa: F401
from . import imdb  # noqa: F401
from . import imikolov  # noqa: F401
from . import mnist  # noqa: F401
from . import movielens  # noqa: F401
from . import mq2007  # noqa: F401
from . import sentiment  # noqa: F401
from . import uci_housing  # noqa: F401
from . import voc2012  # noqa: F401
from . import wmt14  # noqa: F401
from . import wmt16  # noqa: F401
