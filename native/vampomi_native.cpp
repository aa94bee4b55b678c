// vampomi_tpu native IO runtime.
//
// Counterpart of the reference's C++ IO layer (MPI-IO slab
// reads/writes, utilities.cpp:241-267 and the chunked collective templates
// utilities.hpp:70-124; positional fixed-width CSV rows utilities.cpp:366-401).
// MPI is replaced by per-host pread/pwrite into one shared file — each host
// touches only its own byte range, which is exactly what the reference's
// MPI_File_set_view achieved.
//
// Exposed via the plain CPython C API (no pybind11 in this image):
//   read_into(path, buffer, file_byte_offset)          -> bytes read
//   read_f64_as_f32(path, f32_buffer, file_byte_offset)-> doubles converted
//   write_from(path, buffer, file_byte_offset)         -> bytes written
//   write_csv_row(path, iteration, values)             -> row string written
//   format_csv_row(iteration, values)                  -> bytes (for tests)
//
// The hot entry point is read_f64_as_f32: it streams the (possibly huge)
// float64 marker slab through a small chunk buffer and narrows to float32
// in-flight, so loading an 8 GB f64 file into an f32 design matrix needs no
// second full-size temporary (the pure-numpy path materializes f64 first).
// Reads are parallelized over worker threads with pread (thread-safe,
// offset-explicit), with the GIL released.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr size_t kChunkBytes = 8ull << 20;  // 8 MiB streaming chunks

int open_read(const char* path, std::string* err) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) *err = std::string("open('") + path + "') failed: " + strerror(errno);
    return fd;
}

// Fully read [offset, offset+len) into dst; returns false + err on failure.
bool pread_all(int fd, char* dst, size_t len, off_t offset, std::string* err) {
    size_t done = 0;
    while (done < len) {
        ssize_t r = ::pread(fd, dst + done, len - done, offset + (off_t)done);
        if (r < 0) {
            if (errno == EINTR) continue;
            *err = std::string("pread failed: ") + strerror(errno);
            return false;
        }
        if (r == 0) {
            *err = "pread hit EOF before reading requested range";
            return false;
        }
        done += (size_t)r;
    }
    return true;
}

bool pwrite_all(int fd, const char* src, size_t len, off_t offset, std::string* err) {
    size_t done = 0;
    while (done < len) {
        ssize_t w = ::pwrite(fd, src + done, len - done, offset + (off_t)done);
        if (w < 0) {
            if (errno == EINTR) continue;
            *err = std::string("pwrite failed: ") + strerror(errno);
            return false;
        }
        done += (size_t)w;
    }
    return true;
}

size_t pick_threads(size_t total_bytes) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    size_t by_size = std::max<size_t>(1, total_bytes / (64ull << 20));  // 1 per 64 MiB
    return std::min<size_t>(hw, std::min<size_t>(by_size, 16));
}

// Parallel raw read into dst.
bool parallel_read(const char* path, char* dst, size_t len, off_t offset,
                   std::string* err) {
    size_t nthreads = pick_threads(len);
    if (nthreads <= 1) {
        int fd = open_read(path, err);
        if (fd < 0) return false;
        bool ok = pread_all(fd, dst, len, offset, err);
        ::close(fd);
        return ok;
    }
    std::vector<std::thread> threads;
    std::vector<std::string> errs(nthreads);
    std::vector<char> oks(nthreads, 1);  // NOT vector<bool>: bit-packed RMW races across threads
    size_t per = (len + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; t++) {
        size_t lo = t * per;
        size_t hi = std::min(len, lo + per);
        if (lo >= hi) break;
        threads.emplace_back([&, t, lo, hi]() {
            int fd = open_read(path, &errs[t]);
            if (fd < 0) { oks[t] = 0; return; }
            oks[t] = pread_all(fd, dst + lo, hi - lo, offset + (off_t)lo, &errs[t]) ? 1 : 0;
            ::close(fd);
        });
    }
    for (auto& th : threads) th.join();
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

// Streamed f64 -> f32 narrowing read: one worker per contiguous range, each
// with its own chunk buffer.
bool parallel_read_f64_as_f32(const char* path, float* dst, size_t n_doubles,
                              off_t offset, std::string* err) {
    size_t total_bytes = n_doubles * 8;
    size_t nthreads = pick_threads(total_bytes);
    size_t per_vals = (n_doubles + nthreads - 1) / nthreads;

    std::vector<std::thread> threads;
    std::vector<std::string> errs(std::max<size_t>(nthreads, 1));
    std::vector<char> oks(std::max<size_t>(nthreads, 1), 1);  // NOT vector<bool>: bit-packed RMW races

    auto work = [&](size_t t, size_t lo, size_t hi) {
        int fd = open_read(path, &errs[t]);
        if (fd < 0) { oks[t] = 0; return; }
        std::vector<double> buf(std::min(kChunkBytes / 8, hi - lo));
        size_t pos = lo;
        while (pos < hi) {
            size_t cnt = std::min(buf.size(), hi - pos);
            if (!pread_all(fd, (char*)buf.data(), cnt * 8,
                           offset + (off_t)(pos * 8), &errs[t])) {
                oks[t] = 0;
                ::close(fd);
                return;
            }
            float* out = dst + pos;
            for (size_t i = 0; i < cnt; i++) out[i] = (float)buf[i];
            pos += cnt;
        }
        ::close(fd);
    };

    if (nthreads <= 1) {
        work(0, 0, n_doubles);
    } else {
        for (size_t t = 0; t < nthreads; t++) {
            size_t lo = t * per_vals;
            size_t hi = std::min(n_doubles, lo + per_vals);
            if (lo >= hi) break;
            threads.emplace_back(work, t, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

// Fused streamed ingest + per-marker standardization statistics.  The
// reference computes marker mean / inverse-sd in a separate native
// OpenMP+SIMD pass after the collective read (src/data.cpp:233-283); here
// the f64 -> f32 narrowing read and the f64 statistics share one pass over
// the file, so loading never re-reads the matrix from host memory.  Threads
// split on whole marker rows so each row's statistics have a single owner;
// per row: sequential f64 sum -> mean, then centered sum of squares (the
// same two-pass formula as the numpy fallback).
bool parallel_read_f64_as_f32_stats(const char* path, float* dst,
                                    size_t n_rows, size_t n_cols,
                                    off_t offset, double* mave, double* sumsq,
                                    std::string* err) {
    if (n_cols == 0) { *err = "n_cols must be positive"; return false; }
    if (n_rows == 0) return true;  // empty slab: nothing to read or compute
    size_t total_bytes = n_rows * n_cols * 8;
    size_t nthreads = std::min(pick_threads(total_bytes), n_rows);
    size_t per_rows = (n_rows + nthreads - 1) / nthreads;

    std::vector<std::thread> threads;
    std::vector<std::string> errs(std::max<size_t>(nthreads, 1));
    std::vector<char> oks(std::max<size_t>(nthreads, 1), 1);

    auto work = [&](size_t t, size_t rlo, size_t rhi) {
        int fd = open_read(path, &errs[t]);
        if (fd < 0) { oks[t] = 0; return; }
        size_t chunk_rows = std::max<size_t>(1, (kChunkBytes / 8) / n_cols);
        std::vector<double> buf(std::min(chunk_rows, rhi - rlo) * n_cols);
        for (size_t r = rlo; r < rhi; r += chunk_rows) {
            size_t rows = std::min(chunk_rows, rhi - r);
            if (!pread_all(fd, (char*)buf.data(), rows * n_cols * 8,
                           offset + (off_t)((r - 0) * n_cols * 8), &errs[t])) {
                oks[t] = 0;
                ::close(fd);
                return;
            }
            for (size_t i = 0; i < rows; i++) {
                const double* src = buf.data() + i * n_cols;
                float* out = dst + (r + i) * n_cols;
                double s = 0.0;
                for (size_t j = 0; j < n_cols; j++) {
                    s += src[j];
                    out[j] = (float)src[j];
                }
                double mean = s / (double)n_cols;
                double ss = 0.0;
                for (size_t j = 0; j < n_cols; j++) {
                    double d = src[j] - mean;
                    ss += d * d;
                }
                mave[r + i] = mean;
                sumsq[r + i] = ss;
            }
        }
        ::close(fd);
    };

    if (nthreads <= 1) {
        work(0, 0, n_rows);
    } else {
        for (size_t t = 0; t < nthreads; t++) {
            size_t lo = t * per_rows;
            size_t hi = std::min(n_rows, lo + per_rows);
            if (lo >= hi) break;
            threads.emplace_back(work, t, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// Python bindings
// ---------------------------------------------------------------------------

static PyObject* py_read_into(PyObject*, PyObject* args) {
    const char* path;
    Py_buffer view;
    unsigned long long offset;
    if (!PyArg_ParseTuple(args, "sw*K", &path, &view, &offset)) return nullptr;

    std::string err;
    bool ok;
    Py_BEGIN_ALLOW_THREADS
    ok = parallel_read(path, (char*)view.buf, (size_t)view.len, (off_t)offset, &err);
    Py_END_ALLOW_THREADS
    size_t len = (size_t)view.len;
    PyBuffer_Release(&view);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, err.c_str());
        return nullptr;
    }
    return PyLong_FromSize_t(len);
}

static PyObject* py_read_f64_as_f32(PyObject*, PyObject* args) {
    const char* path;
    Py_buffer view;
    unsigned long long offset;
    if (!PyArg_ParseTuple(args, "sw*K", &path, &view, &offset)) return nullptr;
    if (view.len % 4 != 0) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "buffer must hold float32 values");
        return nullptr;
    }
    size_t n = (size_t)view.len / 4;
    std::string err;
    bool ok;
    Py_BEGIN_ALLOW_THREADS
    ok = parallel_read_f64_as_f32(path, (float*)view.buf, n, (off_t)offset, &err);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, err.c_str());
        return nullptr;
    }
    return PyLong_FromSize_t(n);
}

static PyObject* py_read_f64_as_f32_stats(PyObject*, PyObject* args) {
    const char* path;
    Py_buffer view, mview, sview;
    unsigned long long offset, n_cols;
    if (!PyArg_ParseTuple(args, "sw*KKw*w*", &path, &view, &offset, &n_cols,
                          &mview, &sview))
        return nullptr;
    bool shape_ok = n_cols > 0 && view.len % (4 * n_cols) == 0;
    size_t n_rows = shape_ok ? (size_t)view.len / (4 * n_cols) : 0;
    if (!shape_ok || (size_t)mview.len != n_rows * 8 ||
        (size_t)sview.len != n_rows * 8) {
        PyBuffer_Release(&view);
        PyBuffer_Release(&mview);
        PyBuffer_Release(&sview);
        PyErr_SetString(PyExc_ValueError,
                        "buffers must be (rows*n_cols) f32 and rows f64");
        return nullptr;
    }
    std::string err;
    bool ok;
    Py_BEGIN_ALLOW_THREADS
    ok = parallel_read_f64_as_f32_stats(
        path, (float*)view.buf, n_rows, (size_t)n_cols, (off_t)offset,
        (double*)mview.buf, (double*)sview.buf, &err);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&view);
    PyBuffer_Release(&mview);
    PyBuffer_Release(&sview);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, err.c_str());
        return nullptr;
    }
    return PyLong_FromSize_t(n_rows);
}

static PyObject* py_write_from(PyObject*, PyObject* args) {
    const char* path;
    Py_buffer view;
    unsigned long long offset;
    if (!PyArg_ParseTuple(args, "sy*K", &path, &view, &offset)) return nullptr;

    std::string err;
    bool ok = true;
    Py_BEGIN_ALLOW_THREADS
    int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) {
        err = std::string("open('") + path + "') failed: " + strerror(errno);
        ok = false;
    } else {
        ok = pwrite_all(fd, (const char*)view.buf, (size_t)view.len, (off_t)offset, &err);
        ::close(fd);
    }
    Py_END_ALLOW_THREADS
    size_t len = (size_t)view.len;
    PyBuffer_Release(&view);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, err.c_str());
        return nullptr;
    }
    return PyLong_FromSize_t(len);
}

// Format "%5d" + ", %20.15f"*k + "\n" with C printf semantics (the byte
// contract of reference utilities.cpp:366-385).
static bool format_row(long iteration, PyObject* values, std::string* out,
                       std::string* err) {
    char buf[64];
    // snprintf returns the WOULD-BE length; clamp so a pathological value
    // (>63 rendered chars) cannot over-read the stack buffer
    int cx = snprintf(buf, sizeof(buf), "%5ld", iteration);
    if (cx < 0) { *err = "snprintf failed"; return false; }
    cx = std::min(cx, (int)sizeof(buf) - 1);
    out->assign(buf, (size_t)cx);
    Py_ssize_t n = PySequence_Size(values);
    if (n < 0) { *err = "values must be a sequence"; return false; }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* item = PySequence_GetItem(values, i);
        if (!item) { *err = "bad sequence item"; return false; }
        double v = PyFloat_AsDouble(item);
        Py_DECREF(item);
        if (v == -1.0 && PyErr_Occurred()) { *err = "non-float value"; return false; }
        cx = snprintf(buf, sizeof(buf), ", %20.15f", v);
        if (cx < 0) { *err = "snprintf failed"; return false; }
        cx = std::min(cx, (int)sizeof(buf) - 1);
        out->append(buf, (size_t)cx);
    }
    out->push_back('\n');
    return true;
}

static PyObject* py_format_csv_row(PyObject*, PyObject* args) {
    long iteration;
    PyObject* values;
    if (!PyArg_ParseTuple(args, "lO", &iteration, &values)) return nullptr;
    std::string row, err;
    if (!format_row(iteration, values, &row, &err)) {
        if (!PyErr_Occurred()) PyErr_SetString(PyExc_ValueError, err.c_str());
        return nullptr;
    }
    return PyBytes_FromStringAndSize(row.data(), (Py_ssize_t)row.size());
}

static PyObject* py_write_csv_row(PyObject*, PyObject* args) {
    const char* path;
    long iteration;
    PyObject* values;
    if (!PyArg_ParseTuple(args, "slO", &path, &iteration, &values)) return nullptr;
    std::string row, err;
    if (!format_row(iteration, values, &row, &err)) {
        if (!PyErr_Occurred()) PyErr_SetString(PyExc_ValueError, err.c_str());
        return nullptr;
    }
    // positional offset: iteration * row length (reference utilities.cpp:383)
    off_t offset = (off_t)iteration * (off_t)row.size();
    bool ok = true;
    Py_BEGIN_ALLOW_THREADS
    int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) {
        err = std::string("open('") + path + "') failed: " + strerror(errno);
        ok = false;
    } else {
        ok = pwrite_all(fd, row.data(), row.size(), offset, &err);
        ::close(fd);
    }
    Py_END_ALLOW_THREADS
    if (!ok) {
        PyErr_SetString(PyExc_OSError, err.c_str());
        return nullptr;
    }
    return PyLong_FromSize_t(row.size());
}

static PyMethodDef Methods[] = {
    {"read_into", py_read_into, METH_VARARGS,
     "read_into(path, writable_buffer, file_byte_offset) -> bytes read.\n"
     "Threaded pread of a byte range into the buffer."},
    {"read_f64_as_f32", py_read_f64_as_f32, METH_VARARGS,
     "read_f64_as_f32(path, f32_buffer, file_byte_offset) -> count.\n"
     "Stream float64 file data into a float32 buffer, converting in-flight."},
    {"read_f64_as_f32_stats", py_read_f64_as_f32_stats, METH_VARARGS,
     "read_f64_as_f32_stats(path, f32_buf, byte_offset, n_cols, mave_f64_buf,"
     " sumsq_f64_buf) -> rows.\n"
     "Fused streamed ingest + per-row mean / centered sum of squares."},
    {"write_from", py_write_from, METH_VARARGS,
     "write_from(path, buffer, file_byte_offset) -> bytes written."},
    {"format_csv_row", py_format_csv_row, METH_VARARGS,
     "format_csv_row(iteration, values) -> bytes (C printf semantics)."},
    {"write_csv_row", py_write_csv_row, METH_VARARGS,
     "write_csv_row(path, iteration, values) -> row length; positional write."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "vampomi_tpu native IO runtime (pread/pwrite slab IO, fused f64->f32 "
    "ingest, positional CSV rows)",
    -1, Methods,
};

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
