"""OpenAI Files API backing store (local disk).

The port's copy of ``production_stack_tpu/router/files_service.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/services/files_service/ of the upstream vLLM production stack
(FileStorage file_storage.py:27-136, OpenAIFile). Async file IO via
asyncio.to_thread (aiofiles is not in this environment).
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid
from dataclasses import asdict, dataclass
from typing import Optional


@dataclass
class OpenAIFile:
    id: str
    bytes: int
    created_at: int
    filename: str
    object: str = "file"
    purpose: str = "batch"

    def metadata(self) -> dict:
        return asdict(self)


class FileStorage:
    def __init__(self, base_path: str = "/tmp/tpu_router_files"):
        self.base_path = base_path
        os.makedirs(base_path, exist_ok=True)

    def _dir(self, file_id: str) -> str:
        return os.path.join(self.base_path, file_id)

    async def save_file(
        self, content: bytes, filename: str, purpose: str = "batch",
        file_id: Optional[str] = None,
    ) -> OpenAIFile:
        file_id = file_id or f"file-{uuid.uuid4().hex}"
        f = OpenAIFile(
            id=file_id, bytes=len(content), created_at=int(time.time()),
            filename=filename, purpose=purpose,
        )

        def _write():
            os.makedirs(self._dir(file_id), exist_ok=True)
            with open(os.path.join(self._dir(file_id), filename), "wb") as fh:
                fh.write(content)
            with open(os.path.join(self._dir(file_id), "metadata.json"), "w") as fh:
                json.dump(f.metadata(), fh)

        await asyncio.to_thread(_write)
        return f

    async def get_file(self, file_id: str) -> OpenAIFile:
        def _read():
            with open(os.path.join(self._dir(file_id), "metadata.json")) as fh:
                return OpenAIFile(**json.load(fh))

        try:
            return await asyncio.to_thread(_read)
        except FileNotFoundError:
            raise KeyError(file_id)

    async def get_file_content(self, file_id: str) -> bytes:
        meta = await self.get_file(file_id)

        def _read():
            with open(os.path.join(self._dir(file_id), meta.filename), "rb") as fh:
                return fh.read()

        return await asyncio.to_thread(_read)

    async def list_files(self) -> list[OpenAIFile]:
        out = []
        for fid in sorted(os.listdir(self.base_path)):
            try:
                out.append(await self.get_file(fid))
            except (KeyError, json.JSONDecodeError):
                continue
        return out

    async def delete_file(self, file_id: str) -> None:
        import shutil

        await asyncio.to_thread(shutil.rmtree, self._dir(file_id), True)


_storage: Optional[FileStorage] = None


def initialize_storage(base_path: str) -> FileStorage:
    global _storage
    _storage = FileStorage(base_path)
    return _storage


def get_storage() -> FileStorage:
    assert _storage is not None, "file storage not initialized"
    return _storage
