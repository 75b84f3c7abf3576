"""The paper's own evaluation models (ETuner §V-A): ResNet50, MobileNetV2,
DeiT-tiny (CV) and BERT-base (NLP), full size and reduced (CPU-runnable)
— the same values as `repro.configs.paper_models`."""
from repro_torch.configs.base import ModelConfig

RESNET50 = ModelConfig(
    name="resnet50", family="cnn", image_size=128, num_classes=50,
)
MOBILENETV2 = ModelConfig(
    name="mobilenetv2", family="cnn", image_size=128, num_classes=50,
    width_mult=1.0,
)
DEIT_TINY = ModelConfig(
    name="deit-tiny", family="vit", image_size=224, num_classes=50,
    num_layers=12, d_model=192, num_heads=3, num_kv_heads=3, head_dim=64,
    d_ff=768, act="gelu",
)
BERT_BASE = ModelConfig(
    name="bert-base", family="encoder", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=12, head_dim=64, d_ff=3072, vocab_size=30522,
    num_classes=20, act="gelu",
)


def resnet_reduced() -> ModelConfig:
    return RESNET50.replace(name="resnet-reduced", image_size=32, num_classes=10)


def mobilenet_reduced() -> ModelConfig:
    return MOBILENETV2.replace(name="mobilenetv2-reduced", image_size=32,
                               num_classes=10, width_mult=0.5)


def deit_reduced() -> ModelConfig:
    return DEIT_TINY.replace(name="deit-reduced", image_size=32, num_layers=4,
                             d_model=64, num_heads=4, num_kv_heads=4,
                             head_dim=16, d_ff=128, num_classes=10)


def bert_reduced() -> ModelConfig:
    return BERT_BASE.replace(name="bert-reduced", num_layers=4, d_model=64,
                             num_heads=4, num_kv_heads=4, head_dim=16,
                             d_ff=128, vocab_size=512, num_classes=10)
