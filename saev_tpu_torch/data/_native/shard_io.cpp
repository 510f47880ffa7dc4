// Native shard I/O helpers for the host dataloaders.
//
// The loaders stream (example-chunk x token) slices out of large float32
// memmaps (saev_tpu_torch/data/shuffled.py). The kernel's default readahead is
// reactive; these helpers make it proactive:
//   - sx_advise_sequential: POSIX_FADV_SEQUENTIAL on a file span (doubles the
//     kernel readahead window for the shard scan).
//   - sx_prefetch: POSIX_FADV_WILLNEED on the NEXT chunk's byte range so the
//     page cache fills while the current chunk is being copied into the
//     reservoir.
//   - sx_read_block: positioned read loop (pread) into a caller buffer — an
//     alternative engine to mmap for filesystems where fault-in dominates.
//
// A copy of saev_tpu/data/_native/shard_io.cpp. Built lazily with g++ into
// saev_tpu_torch/_build/ by saev_tpu_torch/data/_native/__init__.py (no pybind11:
// plain C ABI + ctypes). All functions return 0/-errno (or bytes read).

#include <cerrno>
#include <cstdint>
#include <fcntl.h>
#include <unistd.h>

extern "C" {

int sx_open(const char* path) {
    int fd = open(path, O_RDONLY);
    return fd >= 0 ? fd : -errno;
}

int sx_close(int fd) { return close(fd) == 0 ? 0 : -errno; }

int sx_advise_sequential(int fd, int64_t offset, int64_t size) {
#ifdef POSIX_FADV_SEQUENTIAL
    int rc = posix_fadvise(fd, offset, size, POSIX_FADV_SEQUENTIAL);
    return rc == 0 ? 0 : -rc;
#else
    (void)fd; (void)offset; (void)size;
    return 0;
#endif
}

int sx_prefetch(int fd, int64_t offset, int64_t size) {
#ifdef POSIX_FADV_WILLNEED
    int rc = posix_fadvise(fd, offset, size, POSIX_FADV_WILLNEED);
    return rc == 0 ? 0 : -rc;
#else
    (void)fd; (void)offset; (void)size;
    return 0;
#endif
}

int64_t sx_read_block(int fd, int64_t offset, int64_t size, void* out) {
    char* dst = static_cast<char*>(out);
    int64_t done = 0;
    while (done < size) {
        ssize_t n = pread(fd, dst + done, static_cast<size_t>(size - done),
                          static_cast<off_t>(offset + done));
        if (n < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (n == 0) break;  // EOF
        done += n;
    }
    return done;
}

}  // extern "C"
