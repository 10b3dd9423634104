"""Neural network modules (torch), NCW inside, the JAX package's layouts at the edges."""
from msla_tpu_torch.nn.attention import MultiHeadAttention
from msla_tpu_torch.nn.bert import BertConfig, BertForMaskedLM
from msla_tpu_torch.nn.decoder import Decoder
from msla_tpu_torch.nn.encoder import Encoder
from msla_tpu_torch.nn.moe import MoEFFN
from msla_tpu_torch.nn.positional import PositionalEncoding
from msla_tpu_torch.nn.residual_stack import ResidualStack
from msla_tpu_torch.nn.transformer_net import DecoderLayer, TransformerQuantizerNet
from msla_tpu_torch.nn.vector_quantizer import VectorQuantizer
from msla_tpu_torch.nn.vqvae_net import QuantizedOutput, VQVAENet, VQVAEOutput

__all__ = ["BertConfig", "BertForMaskedLM", "Decoder", "DecoderLayer", "Encoder", "MoEFFN",
           "MultiHeadAttention", "PositionalEncoding", "QuantizedOutput", "ResidualStack",
           "TransformerQuantizerNet", "VQVAENet", "VQVAEOutput", "VectorQuantizer"]
