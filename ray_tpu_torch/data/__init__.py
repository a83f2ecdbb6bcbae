"""ray_tpu_torch.data: distributed datasets (Data-equivalent).

Reference parity (SURVEY.md §2.5 Ray Data): lazy block-based Datasets,
map_batches over task or GPU-actor pools, distributed shuffle/sort/
groupby, iter_batches/streaming_split feeding trainers.

    import ray_tpu_torch.data as rd

    ds = rd.range(10_000).map_batches(preprocess)
    preds = ds.map_batches(Predictor, concurrency=2, num_gpus=1)
"""

from .block import Block  # noqa: F401
from .context import DataContext  # noqa: F401
from .dataset import ActorPoolStrategy, Dataset, GroupedData  # noqa: F401
from .preprocessor import (  # noqa: F401
    Preprocessor,
    PreprocessorNotFittedException,
)
from . import preprocessors  # noqa: F401
from .streaming import DataIterator  # noqa: F401
from .datasource import (  # noqa: F401
    Datasink,
    Datasource,
    ReadTask,
    read_datasource,
)
from .read_api import (  # noqa: F401
    from_arrow,
    from_huggingface,
    from_items,
    from_numpy,
    from_pandas,
    from_tf,
    from_torch,
    range,
    read_avro,
    read_binary_files,
    read_csv,
    read_images,
    read_json,
    read_numpy,
    read_parquet,
    read_sql,
    read_text,
    read_tfrecords,
    read_webdataset,
)

__all__ = [
    "ActorPoolStrategy", "Block", "DataContext", "DataIterator", "Dataset",
    "Datasink", "Datasource", "GroupedData", "Preprocessor",
    "PreprocessorNotFittedException", "ReadTask", "preprocessors",
    "from_arrow", "from_huggingface",
    "from_items", "from_numpy", "from_pandas", "from_tf", "from_torch",
    "range", "read_avro",
    "read_binary_files", "read_csv", "read_datasource", "read_images",
    "read_json", "read_numpy",
    "read_parquet", "read_sql", "read_text", "read_tfrecords",
    "read_webdataset",
]
