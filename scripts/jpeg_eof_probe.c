/* Decode JPEG files from memory with the host's libjpeg, as the JAX
 * package's native path does (native/fastio.cpp), and report whether
 * libjpeg found the data to end early (its JWRN_JPEG_EOF warning,
 * "Premature end of JPEG file"). For scripts/data_utils/
 * check_jpeg_tail.py.
 *
 *   gcc -O2 -o jpeg_eof_probe scripts/jpeg_eof_probe.c -ljpeg
 *   jpeg_eof_probe < files
 *
 * stdin: records of a 4-byte little-endian length and that many bytes;
 * stdout: one line a record, "eof <0|1> warnings <n>", or "error".
 */
#include <setjmp.h>
#include <stdio.h>
#include <stdlib.h>

#include <jpeglib.h>
#include <jerror.h>

struct probe_err {
  struct jpeg_error_mgr mgr;
  jmp_buf jb;
  int eof;
};

static void on_exit_(j_common_ptr cinfo) {
  longjmp(((struct probe_err*)cinfo->err)->jb, 1);
}

static void on_message(j_common_ptr cinfo, int level) {
  struct probe_err* e = (struct probe_err*)cinfo->err;
  if (level < 0) {
    if (cinfo->err->msg_code == JWRN_JPEG_EOF) e->eof = 1;
    cinfo->err->num_warnings++;
  }
}

int main(void) {
  unsigned char hdr[4];
  while (fread(hdr, 1, 4, stdin) == 4) {
    unsigned long n = hdr[0] | hdr[1] << 8 | hdr[2] << 16 |
                      (unsigned long)hdr[3] << 24;
    unsigned char* buf = malloc(n ? n : 1);
    if (fread(buf, 1, n, stdin) != n) return 1;
    struct jpeg_decompress_struct cinfo;
    struct probe_err err;
    cinfo.err = jpeg_std_error(&err.mgr);
    err.mgr.error_exit = on_exit_;
    err.mgr.emit_message = on_message;
    err.eof = 0;
    if (setjmp(err.jb)) {
      jpeg_destroy_decompress(&cinfo);
      printf("error\n");
      free(buf);
      continue;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, buf, n);
    jpeg_read_header(&cinfo, TRUE);
    if (cinfo.num_components != 4) cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    unsigned char* row =
        malloc((size_t)cinfo.output_width * cinfo.output_components);
    while (cinfo.output_scanline < cinfo.output_height)
      jpeg_read_scanlines(&cinfo, &row, 1);
    jpeg_finish_decompress(&cinfo);
    printf("eof %d warnings %ld\n", err.eof, err.mgr.num_warnings);
    free(row);
    jpeg_destroy_decompress(&cinfo);
    free(buf);
  }
  return 0;
}
