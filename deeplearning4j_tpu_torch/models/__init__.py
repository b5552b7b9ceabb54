"""Model zoo: the workloads ported so far."""

from deeplearning4j_tpu_torch.models.charlstm import char_lstm_conf, char_lstm_network
from deeplearning4j_tpu_torch.models.granite_hybrid import (
    GRANITE_4_0_H_MICRO,
    granite4h_conf,
    granite4h_network,
)
from deeplearning4j_tpu_torch.models.lenet import lenet_conf, lenet_network
from deeplearning4j_tpu_torch.models.recsys import recsys_conf, recsys_network
from deeplearning4j_tpu_torch.models.resnet import (
    resnet50_conf,
    resnet50_network,
    resnet_conf,
    tiny_resnet_conf,
)
from deeplearning4j_tpu_torch.models.vgg16 import vgg16_conf, vgg16_keras_config, vgg16_network
