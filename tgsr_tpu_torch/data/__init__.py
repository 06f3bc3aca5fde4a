"""Caption data: the tokenizer, the dataset adapters and the batch
pipeline (the names tgsr_tpu.data exports)."""
from tgsr_tpu_torch.data.tokenizer import (  # noqa: F401
    Vocab,
    build_dictionary,
    encode_caption,
    tokenize_caption,
)
from tgsr_tpu_torch.data.datasets import (  # noqa: F401
    TextDataset,
    TextExampleSRDataset,
    TextFaceDataset,
    TextFlowerDataset,
    prepare_batch,
)
from tgsr_tpu_torch.data.pipeline import BatchLoader, device_preprocess  # noqa: F401
