// Native IO runtime for expann_tpu.
//
// Counterpart of the reference's C++ data layer: the fvecs/ivecs
// record parser (reference: src/dataset_loader.h:96-125 Tvecs_read) and raw
// binary blob IO used by index persistence (reference:
// src/antitopo_engine.h:930-1074 serialize/deserialize).  Exposed as a tiny
// C ABI consumed from Python via ctypes (pybind11 is not available in this
// image); numpy fallbacks exist for every entry point.
//
// Build: make -C native   (produces libexpann_io.so)

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
    void* data = nullptr;
    int64_t size = 0;
    int fd = -1;
    bool ok() const { return data != nullptr; }
};

MappedFile map_file(const char* path) {
    MappedFile m;
    m.fd = ::open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (::fstat(m.fd, &st) != 0 || st.st_size <= 0) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    m.size = st.st_size;
    void* p = ::mmap(nullptr, (size_t)m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
    if (p == MAP_FAILED) {
        ::close(m.fd);
        m.fd = -1;
        return m;
    }
    ::madvise(p, (size_t)m.size, MADV_SEQUENTIAL);
    m.data = p;
    return m;
}

void unmap_file(MappedFile& m) {
    if (m.data) ::munmap(m.data, (size_t)m.size);
    if (m.fd >= 0) ::close(m.fd);
    m.data = nullptr;
    m.fd = -1;
}

} // namespace

extern "C" {

// Inspect an fvecs/ivecs file: every record is (int32 d, d * 4-byte items).
// Returns 0 on success and fills n (record count) and d (dimension).
int64_t expann_vecs_dims(const char* path, int64_t* n, int64_t* d) {
    MappedFile m = map_file(path);
    if (!m.ok()) return -1;
    if (m.size < 4) {
        unmap_file(m);
        return -2;
    }
    int32_t dim;
    std::memcpy(&dim, m.data, 4);
    if (dim <= 0) {
        unmap_file(m);
        return -3;
    }
    const int64_t rec = 4 + (int64_t)dim * 4;
    if (m.size % rec != 0) {
        unmap_file(m);
        return -4;
    }
    *n = m.size / rec;
    *d = dim;
    unmap_file(m);
    return 0;
}

// Parse the payload of an fvecs/ivecs file into a dense row-major (n, d)
// buffer of 4-byte elements, validating each record's leading dimension.
int64_t expann_vecs_read(const char* path, void* out, int64_t n, int64_t d) {
    MappedFile m = map_file(path);
    if (!m.ok()) return -1;
    const int64_t rec = 4 + d * 4;
    if (m.size != rec * n) {
        unmap_file(m);
        return -4;
    }
    const char* src = (const char*)m.data;
    char* dst = (char*)out;
    for (int64_t i = 0; i < n; ++i) {
        int32_t dim;
        std::memcpy(&dim, src + i * rec, 4);
        if (dim != (int32_t)d) {
            unmap_file(m);
            return -5;
        }
        std::memcpy(dst + i * d * 4, src + i * rec + 4, (size_t)d * 4);
    }
    unmap_file(m);
    return 0;
}

// Raw binary blob write/read (index persistence fast path).
int64_t expann_blob_write(const char* path, const void* data, int64_t nbytes) {
    FILE* f = ::fopen(path, "wb");
    if (!f) return -1;
    const int64_t written = (int64_t)::fwrite(data, 1, (size_t)nbytes, f);
    ::fclose(f);
    return written == nbytes ? 0 : -2;
}

int64_t expann_blob_size(const char* path) {
    struct stat st;
    if (::stat(path, &st) != 0) return -1;
    return (int64_t)st.st_size;
}

int64_t expann_blob_read(const char* path, void* out, int64_t nbytes) {
    MappedFile m = map_file(path);
    if (!m.ok()) return -1;
    if (m.size != nbytes) {
        unmap_file(m);
        return -2;
    }
    std::memcpy(out, m.data, (size_t)nbytes);
    unmap_file(m);
    return 0;
}

} // extern "C"
