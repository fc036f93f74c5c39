from repro_torch.data.pipeline import SyntheticLMData, ByteTokenizer

__all__ = ["SyntheticLMData", "ByteTokenizer"]
