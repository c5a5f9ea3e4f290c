// Bounded ring-buffer block feeder - the native analog of rx_fm's dongle
// thread (src/rtl_fm.c:866-914): a reader thread pulls fixed-size blocks
// from a file descriptor into a bounded queue; the consumer (the Python
// stream runtime) pops blocks without ever blocking on the OS.
//
// Design differences from the reference, on purpose (SURVEY.md §5 "race
// detection"): the reference hands off through ONE rwlock-protected buffer
// and silently overwrites when the consumer lags (rtl_fm.c:858-862); this
// feeder uses a bounded SPSC queue with explicit overflow accounting - a
// lagging consumer *drops whole blocks and counts them* (the "O"-marker
// idiom, rtl_sdr.c:333-337) instead of corrupting one.
//
// Plain C ABI for ctypes.  One mutex + condvar pair; the hot path holds the
// lock only to move head/tail indices.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#include <unistd.h>
#include <errno.h>

namespace {

struct Feeder {
    int fd = -1;
    int64_t block_bytes = 0;
    int64_t depth = 0;              // queue capacity in blocks
    std::vector<uint8_t> buf;       // depth * block_bytes
    std::vector<int64_t> sizes;     // actual bytes in each slot (tail block)
    int64_t head = 0;               // next slot to fill (producer)
    int64_t tail = 0;               // next slot to drain (consumer)
    int64_t count = 0;              // filled slots
    std::atomic<int64_t> overflows{0};
    bool eof = false;
    bool stop = false;
    bool drop_on_full = true;
    std::mutex m;
    std::condition_variable cv_can_produce;
    std::condition_variable cv_can_consume;
    std::thread reader;
};

void reader_main(Feeder* f) {
    std::vector<uint8_t> scratch(f->block_bytes);
    for (;;) {
        // read one full block (short reads only at EOF)
        int64_t got = 0;
        while (got < f->block_bytes) {
            ssize_t r = ::read(f->fd, scratch.data() + got, f->block_bytes - got);
            if (r < 0) {
                if (errno == EINTR) continue;
                got = -1;
                break;
            }
            if (r == 0) break;          // EOF
            got += r;
        }
        std::unique_lock<std::mutex> lk(f->m);
        if (f->stop) return;
        if (got <= 0) {
            f->eof = true;
            f->cv_can_consume.notify_all();
            return;
        }
        if (f->count == f->depth) {
            if (f->drop_on_full) {
                // realtime semantics: drop this block, mark, keep reading
                f->overflows.fetch_add(1, std::memory_order_relaxed);
                continue;
            }
            f->cv_can_produce.wait(lk, [f] { return f->count < f->depth || f->stop; });
            if (f->stop) return;
        }
        std::memcpy(f->buf.data() + f->head * f->block_bytes, scratch.data(), got);
        f->sizes[f->head] = got;
        f->head = (f->head + 1) % f->depth;
        f->count += 1;
        f->cv_can_consume.notify_one();
        if (got < f->block_bytes) {     // short tail => EOF next
            f->eof = true;
            f->cv_can_consume.notify_all();
            return;
        }
    }
}

}  // namespace

extern "C" {

// drop_on_full: 1 = realtime semantics (drop + count), 0 = backpressure
// (reader blocks; right for file replay where no data may be lost).
void* rx_feeder_create(int fd, int64_t block_bytes, int64_t depth,
                       int drop_on_full) {
    auto* f = new Feeder();
    f->fd = fd;
    f->block_bytes = block_bytes;
    f->depth = depth;
    f->buf.resize(depth * block_bytes);
    f->sizes.resize(depth, 0);
    f->drop_on_full = drop_on_full != 0;
    f->reader = std::thread(reader_main, f);
    return f;
}

// Pop one block into dst.  Returns bytes copied, 0 on EOF (queue drained),
// -1 on timeout.  timeout_ms < 0 waits forever.
int64_t rx_feeder_read(void* h, uint8_t* dst, int64_t timeout_ms) {
    auto* f = static_cast<Feeder*>(h);
    std::unique_lock<std::mutex> lk(f->m);
    auto ready = [f] { return f->count > 0 || f->eof || f->stop; };
    if (timeout_ms < 0) {
        f->cv_can_consume.wait(lk, ready);
    } else if (!f->cv_can_consume.wait_for(
                   lk, std::chrono::milliseconds(timeout_ms), ready)) {
        return -1;
    }
    if (f->count == 0) return 0;       // EOF and drained
    int64_t n = f->sizes[f->tail];
    std::memcpy(dst, f->buf.data() + f->tail * f->block_bytes, n);
    f->tail = (f->tail + 1) % f->depth;
    f->count -= 1;
    f->cv_can_produce.notify_one();
    return n;
}

int64_t rx_feeder_overflows(void* h) {
    return static_cast<Feeder*>(h)->overflows.load(std::memory_order_relaxed);
}

int64_t rx_feeder_queued(void* h) {
    auto* f = static_cast<Feeder*>(h);
    std::lock_guard<std::mutex> lk(f->m);
    return f->count;
}

void rx_feeder_destroy(void* h) {
    auto* f = static_cast<Feeder*>(h);
    {
        std::lock_guard<std::mutex> lk(f->m);
        f->stop = true;
    }
    f->cv_can_produce.notify_all();
    f->cv_can_consume.notify_all();
    if (f->reader.joinable()) f->reader.join();
    delete f;
}

}  // extern "C"
