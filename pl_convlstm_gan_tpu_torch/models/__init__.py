"""``nn.Module`` models of the port."""
from .discriminator import Discriminator  # noqa: F401
from .forecaster import ConvLSTMForecaster  # noqa: F401
from .generator import Generator  # noqa: F401
from .layers import Conv2dTorch, ConvLSTMCell  # noqa: F401
from .predrnn import PredRNN  # noqa: F401
