"""OpenAI Batch API: SQLite-backed queue + background processor.

The port's copy of ``production_stack_tpu/router/batch_service.py``;
it imports neither the JAX package nor torch.

Parity: src/vllm_router/services/batch_service/ of the upstream vLLM production stack
(BatchProcessor processor.py:21-58, BatchInfo/BatchStatus batch.py:19-103,
LocalBatchProcessor local_processor.py:32-221). sqlite3 runs in a thread
(aiosqlite is not in this environment).
"""

from __future__ import annotations

import asyncio
import json
import sqlite3
import time
import uuid
from dataclasses import dataclass, field
from typing import Optional

import aiohttp

from production_stack_tpu_torch.router.files_service import FileStorage
from production_stack_tpu_torch.router.utils import cancel_task
from production_stack_tpu_torch.utils.logging import init_logger

logger = init_logger(__name__)


class BatchStatus:
    VALIDATING = "validating"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class BatchInfo:
    id: str
    input_file_id: str
    endpoint: str
    completion_window: str
    status: str = BatchStatus.VALIDATING
    created_at: int = field(default_factory=lambda: int(time.time()))
    output_file_id: Optional[str] = None
    error_file_id: Optional[str] = None
    request_counts: dict = field(default_factory=lambda: {"total": 0, "completed": 0, "failed": 0})
    metadata: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id, "object": "batch", "endpoint": self.endpoint,
            "input_file_id": self.input_file_id,
            "completion_window": self.completion_window, "status": self.status,
            "created_at": self.created_at, "output_file_id": self.output_file_id,
            "error_file_id": self.error_file_id, "request_counts": self.request_counts,
            "metadata": self.metadata,
        }


class LocalBatchProcessor:
    """Processes batches by sending each line's request through the router's
    own HTTP endpoint (so routing logic applies per batch line)."""

    def __init__(self, db_path: str, storage: FileStorage, router_base_url: str):
        self.db_path = db_path
        self.storage = storage
        self.router_base_url = router_base_url
        self._queue: asyncio.Queue[str] = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._db_lock = asyncio.Lock()
        self._init_db()

    def _init_db(self) -> None:
        with sqlite3.connect(self.db_path) as db:
            db.execute(
                "CREATE TABLE IF NOT EXISTS batches (id TEXT PRIMARY KEY, data TEXT)"
            )

    async def _db(self, fn):
        async with self._db_lock:
            return await asyncio.to_thread(fn)

    async def _save(self, info: BatchInfo) -> None:
        def _w():
            with sqlite3.connect(self.db_path) as db:
                db.execute(
                    "INSERT OR REPLACE INTO batches VALUES (?, ?)",
                    (info.id, json.dumps(info.to_dict())),
                )

        await self._db(_w)

    async def start(self) -> None:
        self._task = asyncio.create_task(self._worker())
        # resume unfinished batches after restart (checkpoint/resume parity)
        for info in await self.list_batches():
            if info.status in (BatchStatus.VALIDATING, BatchStatus.IN_PROGRESS):
                await self._queue.put(info.id)

    async def close(self) -> None:
        if self._task:
            await cancel_task(self._task)
            self._task = None

    async def create_batch(
        self, input_file_id: str, endpoint: str, completion_window: str,
        metadata: Optional[dict] = None,
    ) -> BatchInfo:
        info = BatchInfo(
            id=f"batch_{uuid.uuid4().hex}", input_file_id=input_file_id,
            endpoint=endpoint, completion_window=completion_window, metadata=metadata,
        )
        await self._save(info)
        await self._queue.put(info.id)
        return info

    async def retrieve_batch(self, batch_id: str) -> BatchInfo:
        def _r():
            with sqlite3.connect(self.db_path) as db:
                row = db.execute(
                    "SELECT data FROM batches WHERE id = ?", (batch_id,)
                ).fetchone()
            return row

        row = await self._db(_r)
        if row is None:
            raise KeyError(batch_id)
        d = json.loads(row[0])
        d.pop("object", None)
        return BatchInfo(**d)

    async def list_batches(self) -> list[BatchInfo]:
        def _r():
            with sqlite3.connect(self.db_path) as db:
                return db.execute("SELECT data FROM batches").fetchall()

        rows = await self._db(_r)
        out = []
        for (data,) in rows:
            d = json.loads(data)
            d.pop("object", None)
            out.append(BatchInfo(**d))
        return sorted(out, key=lambda b: b.created_at, reverse=True)

    async def cancel_batch(self, batch_id: str) -> BatchInfo:
        info = await self.retrieve_batch(batch_id)
        if info.status in (BatchStatus.VALIDATING, BatchStatus.IN_PROGRESS):
            info.status = BatchStatus.CANCELLED
            await self._save(info)
        return info

    async def _worker(self) -> None:
        while True:
            batch_id = await self._queue.get()
            try:
                await self._process(batch_id)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("batch %s failed", batch_id)
                try:
                    info = await self.retrieve_batch(batch_id)
                    info.status = BatchStatus.FAILED
                    await self._save(info)
                except KeyError:
                    pass

    async def _process(self, batch_id: str) -> None:
        info = await self.retrieve_batch(batch_id)
        if info.status == BatchStatus.CANCELLED:
            return
        content = await self.storage.get_file_content(info.input_file_id)
        lines = [l for l in content.decode().splitlines() if l.strip()]
        info.status = BatchStatus.IN_PROGRESS
        info.request_counts["total"] = len(lines)
        await self._save(info)
        results = []
        async with aiohttp.ClientSession() as session:
            for line in lines:
                info = await self.retrieve_batch(batch_id)
                if info.status == BatchStatus.CANCELLED:
                    return
                try:
                    req = json.loads(line)
                    async with session.post(
                        f"{self.router_base_url}{req.get('url', info.endpoint)}",
                        json=req.get("body", {}),
                    ) as resp:
                        body = await resp.json()
                        ok = resp.status == 200
                    results.append(
                        {
                            "id": f"batch_req_{uuid.uuid4().hex[:12]}",
                            "custom_id": req.get("custom_id"),
                            "response": {"status_code": resp.status, "body": body},
                            "error": None if ok else {"message": str(body)},
                        }
                    )
                    info.request_counts["completed" if ok else "failed"] += 1
                except Exception as e:
                    results.append(
                        {
                            "id": f"batch_req_{uuid.uuid4().hex[:12]}",
                            "custom_id": None,
                            "response": None,
                            "error": {"message": str(e)},
                        }
                    )
                    info.request_counts["failed"] += 1
                await self._save(info)
        out = "\n".join(json.dumps(r) for r in results).encode()
        f = await self.storage.save_file(out, "output.jsonl", purpose="batch_output")
        info.output_file_id = f.id
        info.status = BatchStatus.COMPLETED
        await self._save(info)
        logger.info("batch %s completed: %s", batch_id, info.request_counts)


_processor: Optional[LocalBatchProcessor] = None


def initialize_batch_processor(
    db_path: str, storage: FileStorage, router_base_url: str
) -> LocalBatchProcessor:
    global _processor
    _processor = LocalBatchProcessor(db_path, storage, router_base_url)
    return _processor


def get_batch_processor() -> LocalBatchProcessor:
    assert _processor is not None, "batch processor not initialized"
    return _processor
